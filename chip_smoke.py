#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card (Hopper:
the kernel is built for sm_90a) and the CUDA toolkit. It needs no network
and no weights: everything is made from seeds. Phases, one line or more each:

1. card: name and power limit (nvidia-smi) and torch's device name;
2. build: nvcc compiles the four kernel sources (K1, the FiLM cond chain's
   forward; K2, its backward; both on the tensor cores as 3xTF32 through
   csrc/tf32x3.cuh, K1 and K2's data kernel on Hopper's wgmma through
   csrc/cond_chain_f32.cuh and csrc/hopper_bf16.cuh; and their bf16
   instances, K1-bf16 and K2-bf16, through csrc/cond_chain_bf16.cuh and
   csrc/hopper_bf16.cuh), one nvcc per source, started together, with each
   kernel's registers and spills;
3. parity: K1 against its plain PyTorch version at the four decoder-stage
   shapes of an 8960-sample segment (B=2), split and concat forms; then at
   the chain shapes that phases 9 and 10 give it (B=1 at each test
   utterance's validation and sample bucket, B=4 at its conversion bucket,
   every stage);
4. slice: the full-width conv-encoder Converter runs pitch_batch (Viterbi)
   and convert_batch on 16 x 71680 samples: output checks, kernel launches
   counted over that run, the same call with the plain chain, a small input
   against the CPU path, the conversion real-time factor, and one convert
   call's device time by kernel (torch.profiler);
5. K1 times at the conversion path's four stage shapes and at the train
   step's eight (stage, batch) shapes, each beside two bounds (the card's
   3xTF32 tensor-core rate and its f32 CUDA-core rate), the plain version
   and a cuDNN sequence (a yardstick the port never calls);
6. K2 parity: every output of K2 against cond_chain_bwd_plain at the four
   training stage shapes (B=2), split and concat forms, and gradients
   through MRFBlock.films, the kernels against the plain chain; then K1 and
   K2 (a second run bit for bit) at widths off the decoder's defaults
   (Cc = 264; E = 6 and 10; Cc = 11 and 138, which the wrapper pads; split
   Cc = 1290; concat E = Cc = 600; 2C = 1032), and at every stage's shape
   for widths of several passes of 136 channels (split Cc = 392 and 1204,
   concat Cc = 184 and 344); then K2 through its C entry point at a width
   where its reduce has a gap of threads before a job summed by warps
   (GUARD_CASE), with guard elements after every output that must come back
   unchanged;
7. train: the full-width stage-2 GAN train step (D -> C -> G, the config
   defaults, conv encoder) on 16 x 8960 samples: its first step against the
   same step with the plain chain, then a warm-up and timed steps (CUDA
   events) with 8 K1 and 8 K2 launches counted in each, loss and parameter
   checks, peak memory, and one step's device time by kernel; then the bare
   step with the next batch made beside it by threads (8; 8 with a longer
   switch interval; 1) and by the package's worker processes, from the
   corpus of phase 9;
8. K2 at the step's eight (stage, batch) shapes: against its plain
   version, a second run bit for bit, then its time beside the two bounds,
   the plain version and cuDNN's backward of the same chain (a yardstick),
   its device time by kernel (the events its library records between
   launches) at each shape and per step, ``k2_w1_kernel``'s per step
   against its own bound (dW1's flops at the 3xTF32 rate), its launches per
   call, and its workspace at the step's largest call;
9. the train CLI (``python -m td_vc_gan_tpu_torch.cli.train``, a
   subprocess) on a corpus the script writes (16 speakers x 6 utterances of
   1.5-4 s, 4 of them FLAC): epoch 0 (5 steps at batch 16, through the
   data pipeline with its corruption), validation, a checkpoint and sample
   dumps, then a resume for 2 more steps; checks on
   the losses, the kernel launches of every step, the resumed state, the
   reference-format export and the samples; the loop's step time beside
   phase 7's, its wait on the input pipeline, the host's corruption time per
   batch, checkpoint seconds and bytes, peak device memory;
10. the conversion CLI (``python -m td_vc_gan_tpu_torch.cli.generate_with_target``,
   a subprocess) on that run: 4 test utterances to each of the 4 speakers
   of the test manifest, file and log checks, K1 launches per convert_batch
   call, wall time and RTF;
11. wavlm convert: the full-width wavlm-stage2_2 Converter (WavLM-Large
   from a seed, the 16-layer posterior encoder, phase 4's decoder) and
   CREPE-tiny on phase 4's batch: 4 K1 launches per call, output checks,
   the plain-chain path, the backbone's features on the card against the
   CPU's (one 1 s utterance), convert ms, RTF, pitch ms, the backbone alone
   and its share of a profiled call;
12. wavlm train: the full-width wavlm-stage2_2 train step on 16 x 8960, as
   phase 7's (one function, ``phase_step``, runs phases 7, 12 and 18), the
   backbone bit-identical after the timed steps, with no gradient;
13. the wavlm CLIs: WavLM-Large from a seed written as a Microsoft
   ``WavLM-Large.pt``; the train CLI with ``--wavlm_checkpoint`` on phase
   9's corpus (epoch 0 with a save, then a resume for 2 steps), then the
   conversion CLI on that run; the backbone's digest after loading, after
   the resume and in the conversion CLI against the written file's, K1 and
   K2 in every step, save time and bytes.

14. bf16 kernels: K1-bf16 and K2-bf16 (the bf16 instances: wgmma products
   fed by TMA through mbarrier rings, csrc/hopper_bf16.cuh) against their
   plain bf16 versions (within one bf16 ulp but for a stated share of
   elements, and max|d| within 2^-7 of max|plain|), every output, at the four
   training stages in both forms, at E = 6 and 10 and at Cc = 600, 1204 and
   2000 (5, 9 and 15 passes of 136 columns), and at the first stage's T at
   Cc = 11 and 138 (padded to multiples of 4), split Cc = 1290, concat
   E = Cc = 600 and 2C = 1032, K2-bf16 bit for bit in a second run; their
   times at the
   bf16 conversion's four stage shapes (K1) and at the batch-64 train step's
   eight (K1, K2), each beside two bounds (the dense bf16 tensor-core rate
   and the memory rate), the plain bf16 version, the f32 kernel and cuDNN's
   bf16 sequence (a yardstick); K2-bf16's device time by kernel at each of
   the eight shapes and per step (torch.profiler), its launches per call,
   and its workspace at the step's largest call;
15. bf16 convert: ``train.compute_dtype: bfloat16`` conversion of phase 4's
   batch with each encoder (the WavLM backbone in bf16): 4 K1-bf16 launches
   per call and no f32 K1, the output (f32, finite, max|y| <= 1), the
   plain-bf16-chain path, the f32 conversion with the same weights and
   draws (max|d| and SNR), RTF, pitch (f32), peak memory, a profile;
16. bf16 train: the bf16 train step at batch 64 x 8960 (the JAX package's
   headline, wavlm-stage2_2, then the conv encoder): its first step against
   the plain-bf16-chain step, timed steps with 8 K1-bf16 and 8 K2-bf16 and
   no f32 K1 or K2 each, parameters and AdamW moments f32, every trainable
   parameter changed, peak memory, a profile;
17. the CLIs in bf16: the train CLI with ``--override
   train.compute_dtype=bfloat16`` (conv encoder; epoch 0 with a save, then a
   resume without the override, which takes bf16 from the train state), then
   the conversion CLI on that run, with the bf16 kernels;
18. stage steps: the full-width f32 train step (16 x 8960) at the
   curriculum's first stages: S1 (conv_enc-stage1: no cycle pass, the
   converted contrastive term encoding the fake batch, the latent
   classifier) and S21 (stage 2-1) with the conv encoder, W1 (wavlm-stage1's
   settings: no_conv, jitter) with WavLM-Large from a seed; each one's first
   step against the plain-chain step (losses and first moments), timed steps
   with 4 K1 and 4 K2 launches each (one decode, no cycle pass), every
   trainable tensor changed, W1's backbone bit-identical, peak memory, a
   profile;
19. the curriculum through the CLIs, conv encoder (the two train runs each a
   subprocess, the other CLIs' ``main`` in turn in one child process, which
   imports torch once): phase
   9's utterances as raw speaker folders (all WAV); ``prepare_dataset``,
   ``preprocess_dataset`` (-30 dB, in place), ``subset_dataset`` (4 x 1 of
   the test manifest), ``precorrupt_dataset`` (2 variants); stage 1 (S1
   without the latent classifier, epochs 0 and 1, a save each), then stage
   2-1 from stage 1's epoch 0 (``--load_path --epoch 0``, C from the seed,
   the stored variants) for one epoch with a save; on that run
   ``generate_with_target``, ``generate_from_list`` (4 pairs),
   ``generate_from_dataset`` (zero excitation, then ``--use_source_pitch``),
   ``sample_f0`` on the first one's output and ``get_model_info`` on stage
   1's run; every logged loss, 4 K1 + 4 K2 launches per step, 4 K1 per
   convert call, the hand-off, each output's max|y| and file names, each
   CLI's wall time;
20. evaluation: which of transformers, h5py and matplotlib are importable;
   ECAPA-TDNN and MOSNet at their published widths from seeded checkpoints
   (a speechbrain-layout ``embedding_model.ckpt``, a MOSNet ``.npz``) on
   phase 19's 16 test utterances, card against CPU, ms per utterance, peak
   memory, parameter counts; WORLD's and the DTW's host seconds per
   utterance pair; then ``python -m td_vc_gan_tpu_torch.cli.run_test`` (a
   subprocess) on phase 19's stage-2-1 run (4 test utterances to 4
   speakers): generation (4 K1 per convert call), MCD, ECAPA speaker
   similarity, MOS, ASR with a tiny Whisper written from a seed when
   transformers is there (else a line saying why it did not run), info and
   the HTML report; every result pickle, a finite orig-vs-orig MCD
   baseline, the count of finite conversion MCDs;
21. data parallelism (``td_vc_gan_tpu_torch.parallel``): the full-width
   stage-2 step (16 x 8960, conv encoder) on two ranks over gloo sharing
   cuda:0 (8 items each, two processes), then on every visible card over
   NCCL (one process each; with one card the NCCL path at W = 1), each
   against the one-rank step on the 16 items in this process with the same
   weights and global draws (losses, first moments, parameters; replicas
   and generators bit-identical), each rank's step ms, the mean of G's and
   D's gradients (MB, ms) and its 8 K1 + 8 K2 launches a step; with two or
   more cards the train CLI, one process per card, and a resume (segments
   per second, in all and per rank); then ``convert_long_sharded`` of a
   60 s utterance on [cuda:0], [cuda:0, cuda:0] and every card, against the
   one-device output, RTF, 4 K1 launches per shard call;
22. generator options: the config defaults plus a bottleneck of two FiLM
   blocks on the target speaker, instance norm in the encoder and
   conditional instance norm in the decoder. (a) K1, K2, K1-bf16 and
   K2-bf16 against their plain versions at the bottleneck's chain shapes
   (the concat form, n = 1, B = 16, E = Cc = 128 and 256, 2C = 256, T = 28
   and 224), the backward kernels bit for bit in a second run, each one's
   time through the wrapper and through its C entry point beside its bound,
   plain version and cuDNN; (b) f32 conversion of
   phase 4's batch: K1 launches (4 decoder stages + 2 bottleneck blocks),
   the plain-chain path, a small input against the CPU, ms and RTF beside
   phase 4's, a profile; (c) the f32 train step at 16 x 8960 as phase 7's
   (``phase_step``, 3 timed steps, 12 K1 + 12 K2 a step: two decodes); (d)
   bf16 conversion (6 K1-bf16 launches, no f32 K1, SNR against f32); (e)
   F0Estimator on the card against the CPU.

Phases 1-13 and 18-22 run in float32 (22 also in bf16), with TF32 off in
cuDNN and matmul (the CLIs set the same), as the JAX package's default.
They run in this order: 2-8, 11, 12, 14-16, 18 and 22 one after another,
then five lanes at once, each a thread that runs its phases in turn: 9 and
10; 13; 17; 19 and 20; 21. The lanes spend most of their time starting
processes, so their wall and step times are taken beside one another's
work; the kernel times of phases 5, 8, 14 and 22 are taken alone. Any
failed check raises, and the script then exits non-zero without its result
lines. The last two lines are the JSON kernel table (this run's numbers
only) and the result object; before them, one summary line per phase (its
wall time and headline numbers, read from what it printed), so that the end
of the output holds every phase's numbers, and before those each kernel's
time beside the one recorded for its previous version in PERF.md. The script is the subreaper of every process it starts
(the CLIs and what they start, the data pipeline's workers, ``nvcc``) and,
pass or fail, ends and reaps each of them before it exits.

    python3 chip_smoke.py --ab DIR

runs the card and build phases, then only an A/B of the kernels: the
earlier K1, K2, K1-bf16 and K2-bf16 built from their sources in DIR (the
four .cu files and the headers they include, with this tree's C
interface: K1 with a workspace, K2 on W1 in its own layout)
against this tree's, alternated for 5 rounds at the conversion's chain
shapes and the train step's (f32 at batch 16, bf16 at batch 64), the two
versions' outputs held to each other, K1's time by kernel at the convert
shapes and each backward's time by kernel and workspace for each version,
then all four kernels at the options' bottleneck shapes and at concat
E = Cc = 600 through their C entry points, with cuDNN beside them; its last
line is a JSON object of each dtype's and path's per-round totals.

    python3 chip_smoke.py --timers

runs the card and build phases, then the four kernels built with
-DCOND_CHAIN_TIMERS (diagnostic builds: each consumer warpgroup's clock64
cycles by phase; in K1 (f32) h, A's store, its barriers, P's products and
their waits and the output at the f32 conversion's and the B = 32 step's
stage shapes and the bottleneck's Cc = E = 256; in K1-bf16 h's product, P's products and the
epilogue at the bottleneck shapes and the bf16 conversion's stage shapes;
in the backward data kernels h, da, dh, dexc and X^T dh and their parts at
the step's stage shapes, K2-bf16's also at the bottleneck shapes; the
producers' waits on empty; in k2_w1_kernel X's image, h, a's store, the
products, the run sums and the barrier, in k2b_w1_kernel its compute
warpgroups' and producer's phases). The two flags combine.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import gc
import importlib.metadata
import importlib.util
import inspect
import io
import json
import os
import pickle
import re
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from td_vc_gan_tpu_torch import parallel, testing
from td_vc_gan_tpu_torch.config import Config, load_config, parse_overrides
from td_vc_gan_tpu_torch.data import corruption
from td_vc_gan_tpu_torch.data.audio_io import read_audio, write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset, collate, make_train_iterator
from td_vc_gan_tpu_torch.data.flac import write_flac
from td_vc_gan_tpu_torch.eval import mcd
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models import ecapa, mosnet
from td_vc_gan_tpu_torch.models.crepe import crepe_from_seed
from td_vc_gan_tpu_torch.models.f0_estimator import F0Estimator
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.models.layers import MRFBlock, init_weights
from td_vc_gan_tpu_torch.models.wavlm import WavLM, WavLMConfig, backbone_digest, key_table
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cc_mod
from td_vc_gan_tpu_torch.testing import (
    PARITY_RTOL,
    chain_inputs,
    dyadic,
    microsoft_wavlm_checkpoint,
    stage_shapes,
)
from td_vc_gan_tpu_torch.training import checkpoint as ckpt
from td_vc_gan_tpu_torch.training.loop import _pad_bucket, build_models
from td_vc_gan_tpu_torch.training.state import create_train_state
from td_vc_gan_tpu_torch.training.step import build_train_step

REPO = Path(__file__).resolve().parent

PEAK_F32_FLOPS = 67e12    # H100 SXM, f32 outside the tensor cores (data sheet)
# H100 SXM, the fastest f32-accurate rate: 3xTF32 on the tensor cores, three
# TF32 products (494.7 TFLOP/s dense, data sheet) per f32 product
PEAK_F32_TC_FLOPS = 494.7e12 / 3
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 (data sheet)
AUDIO_ATOL = 1e-3         # converted audio (in [-1, 1]): kernel path vs plain / CPU path
B, UTT = 16, 71680        # the conversion batch the JAX package measured
SEG = 8960                # the training segment
NUM_SPK = 100             # speakers (one-hot classes) of the smoke's models
STAGES = 4                # decoder stages: K1 and K2 run once per stage per G pass
TRAIN_STEPS = 5           # timed train steps, after the twin step and one warm-up
STEP_LOSS_RTOL = 1e-4     # first step's losses: kernel path vs plain-chain path
# First moments (gradients) of that step, per tensor, of its max|ref|: the two
# paths take the leaky_relu slope differently wherever h is within rounding of
# 0 (cuDNN's f32 conv in the plain path rounds h more coarsely than the
# kernel), and each such element moves a cond-weight gradient by one term of
# its B*T-term sum.
STEP_MU_RTOL = 1e-2
# Widths off the decoder's defaults that the kernels take too, as (form,
# conditional_dim, E), held at one stage's shape: a wider speaker embedding
# (Cc = 264: two passes of 136 channels); excitation widths that are not a
# multiple of 4 (K2's dW0 stages exc in 4-byte pieces, in either weight-grad
# tile: E <= 8 and E > 8); Cc = 11 and 138, which the wrapper pads to
# multiples of 4 for K2; split Cc = 1290 (10 passes); concat E = Cc = 600
# (K = 3E + 3 = 1803 for h, 75 chunks of 8 columns of dexc).
WIDE_CASES = (("split", 256, 8), ("split", 130, 6), ("split", 126, 10), ("split", 3, 8),
              ("split", 130, 8), ("split", 1282, 8), ("concat", 592, 8))
# 2C = 1032 (C = 516: 9 output chunks of K1's 128 columns, 129 slices of 8
# of K2's da) at the first stage's T.
WIDE_C = 516
# Widths that take several passes of 136 channels (split Cc = 392 and 1204:
# 3 and 9; concat Cc = 184 and 344: 2 and 3), held at all four stages'
# shapes (2C = 256 down to 32, partial last tiles).
TILED_CASES = (("split", 384, 8), ("concat", 176, 8), ("concat", 336, 8),
               ("split", 1196, 8))
# A width at which K2's reduce has a gap before a job that takes a warp an
# output: split, Cc = 140 (conditional_dim 132, two passes), 2C = 12, E = 8 at
# the second stage's T, B = 16: dW1's 45,360 outputs (one thread each, not a
# multiple of 32) come just before db1's 108, whose 304 partials take a warp
# (the tiles test's "gap-before-a-warp-job"). Held through the C entry point
# with GUARD elements of GUARD_WORD after each output, which must come back
# as they were.
GUARD_CASE = (16, 132, 6)
GUARD, GUARD_WORD = 64, -1234.5
# Each kernel's time in its previous version, as recorded in PERF.md
# section 6 (NVIDIA H100 80GB HBM3, 700 W): K1 and K2 before their Hopper
# redesign (K1 whole, K2's data kernel); K1-bf16 and
# K2-bf16 in their first versions (bf16 mma.sync, operands read per fragment
# through L1), K2-bf16 before its weight grads moved to wgmma, K2 before
# its weight grads did, K1-bf16 before its output chunks got CTAs of their
# own, K2 before dexc's read-modify-write was batched, K2-bf16 before
# its data kernel took X^T dh on chip, K1 before its redesign for the
# narrow stages, and K2 before its data kernel took a CTA per run of tiles
# and X^T dh on chip. As (path
# in the row's by_path, or None for the row's own ms,
# ms, per what, which version). Printed beside this run's on lines of their
# own, never in the JSON kernel table, which holds only this run's numbers.
EARLIER_MS = {
    "cond_chain_fwd": [(None, 25.468, "convert call",
                        "on mma.sync m16n8k8 with cp.async staging"),
                       (None, 15.789, "convert call",
                        "with its taps in one accumulator, a k-slice a ring item and "
                        "its phases in turn"),
                       ("train", 6.438, "train step (8 calls)",
                        "with its taps in one accumulator, a k-slice a ring item and "
                        "its phases in turn")],
    "cond_chain_bwd": [(None, 38.793, "train step",
                        "with its data kernel on mma.sync m16n8k8"),
                       (None, 25.571, "train step",
                        "with its weight grads on mma.sync from the a scratch"),
                       (None, 19.392, "train step",
                        "with dexc's read-modify-write one element at a time"),
                       (None, 17.476, "train step",
                        "with a CTA per tile walking every block and dh through a scratch"),
                       (None, 14.532, "train step",
                        "with k2_w1_kernel's recompute in a warpgroup of its own and a dW1 "
                        "partial a run of 16 units")],
    "cond_chain_fwd_bf16": [
        ("convert", 22.866, "bf16 convert call (4 calls)", "in their first bf16 version"),
        ("train", 34.319, "batch-64 train step (8 calls)", "in their first bf16 version"),
        ("convert", 5.150, "bf16 convert call (4 calls)",
         "with one CTA walking every output chunk"),
        ("train", 8.058, "batch-64 train step (8 calls)",
         "with one CTA walking every output chunk")],
    "cond_chain_bwd_bf16": [
        (None, 26.800, "batch-64 train step (8 calls)",
         "with a CTA a tile, its phases in turn, and the dh scratch"),
        (None, 89.301, "batch-64 train step (8 calls)", "in their first bf16 version"),
        (None, 41.269, "batch-64 train step (8 calls)",
         "with the mma.sync weight grads and the a scratch (PR 15's proof)")]}
# The CLI phases' corpus: speakers x utterances of 1.5-4 s; the first
# TRAIN_UTT of each speaker train (80 files: 5 steps an epoch at batch 16),
# the last of TEST_SPK speakers convert; FLAC_FILES are written as FLAC.
CORPUS_SPK, CORPUS_UTT, TRAIN_UTT = 16, 6, 5
TEST_SPK = (0, 5, 10, 15)
FLAC_FILES = ((0, 1), (5, 2), (10, 3), (15, 4))
CLI_OVERRIDES = ("model.generator.encoder_model=conv", "train.num_epoch=0",
                 "log.log_interval=1", "log.save_interval=1", "log.val_interval=1",
                 "log.gen_interval=1", "log.gen_num=2", "test.num_tests=2")
CLI_TIMEOUT = 300
# The phases that run last, as lanes at once (``main``); this process's
# kernel work in them (phases 20 and 21) takes IN_PROCESS_GPU in turn.
LANES = "9-10, 13, 17, 19-20 and 21"
IN_PROCESS_GPU = threading.Lock()
# The WavLM backbone's features on the card against the CPU's for one 1 s
# utterance, TF32 off: of max|ref| (24 f32 layers, sums in another order; on
# the CPU, f32 against f64 differs by 6.8e-7 of max|ref|; TF32 would give ~1e-3).
FEATURE_RTOL = 1e-4
# The wavlm CLI run: as phase 9's, with the WavLM encoder.
WAVLM_CLI_OVERRIDES = tuple(o.replace("=conv", "=wavlm") for o in CLI_OVERRIDES)
# bf16 mixed precision (phases 14-17).
PEAK_BF16_FLOPS = 989.4e12  # H100 SXM, dense bf16 on the tensor cores (data sheet)
B64 = 64                    # the JAX package's headline train batch (bench.py:110, :112)
# A bf16 kernel against its plain bf16 version, every output: the two sum in
# another order in f32 and round once at the same points, so an element
# differs by one bf16 ulp where the f32 sums straddle a rounding boundary,
# and by more only where an earlier rounding (lrelu(h), dh) flipped or the
# value is a cancellation near 0; at most this share of elements may lie
# beyond one ulp of the plain value ...
BF16_ULP_SHARE = 1e-2
# ... and max|d| <= this of max|plain|.
BF16_MAX_REL = 2.0 ** -7
# Converted audio, bf16 kernel path vs plain-bf16-chain path, as a share of
# max|plain|: the two paths' chain outputs differ by one bf16 ulp in a few
# elements, which the ~40 bf16 layers after them carry to the output, at the
# output's scale. Measured (NVIDIA H100 80GB HBM3, 700 W, with K1-bf16 as it
# was before its output chunks got CTAs of their own): the default G 1.221e-3
# at max|y| 0.0266 (4.6e-2 of it) with the conv encoder, 1.709e-3 at 0.0457
# (3.7e-2) with WavLM; the options G 2.637e-2 at 0.9883 (2.7e-2).
BF16_AUDIO_RTOL = 8e-2
# bf16 conversion against the f32 one (same weights and draws): a gate on
# gross faults, not a quality claim.
BF16_SNR_DB = 20.0
# The bf16 step's first losses, kernel path vs plain-bf16-chain path.
BF16_STEP_LOSS_RTOL = 1e-2
# Widths off the decoder's for the bf16 instances, as (form, conditional_dim,
# E), at all four stages: split Cc = 600 (5 passes of 136 columns of h) and
# Cc = 1204 (9 passes, the last of 116 columns; the weight grads staged
# element by element: n*Cc is not a multiple of 8); excitation widths 6 and
# 10 (not multiples of 8 or 16: padded k-slices, two chunks of 8 in dexc's
# product, dW0 staged element by element).
BF16_TILED_CASES = (("split", 592, 8), ("split", 1196, 8), ("split", 130, 6),
                    ("split", 126, 10))
# At the first stage's T, both kernels, as (form, conditional_dim, E, C or
# None for the stage's): split Cc = 2000 (15 passes); Cc = 11 and 138
# (padded to multiples of 4); split Cc = 1290; concat E = Cc = 600;
# 2C = 1032 (C = 516).
BF16_WIDE_CASES = (("split", 1992, 8, None), ("split", 3, 8, None), ("split", 130, 8, None),
                   ("split", 1282, 8, None), ("concat", 592, 8, None), ("split", 128, 8, 516))


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple[float, float]:
    d = float((got - want).abs().max())
    return d, d / max(float(want.abs().max()), 1e-30)


def bounds(flops: float, nbytes: float) -> tuple[float, float, str]:
    """(bound_ms, bound_simt_ms, bound_by) of work that must do ``flops``
    f32 operations and move ``nbytes``: the least time at the card's fastest
    f32-accurate rate (3xTF32 tensor cores) and at its f32 CUDA-core rate,
    each the larger of the operation and byte times."""
    byte_s = nbytes / PEAK_BYTES
    bound_by = "operations" if flops / PEAK_F32_TC_FLOPS >= byte_s else "bytes"
    return (max(flops / PEAK_F32_TC_FLOPS, byte_s) * 1e3,
            max(flops / PEAK_F32_FLOPS, byte_s) * 1e3, bound_by)


class Totals(dict):
    """Sums of a kernel's per-shape numbers (ms, bounds, plain, library)."""

    KEYS = ("ms", "plain_ms", "bound_ms", "bound_simt_ms", "library_ms", "flops", "bytes")

    def __init__(self):
        super().__init__((k, 0.0) for k in self.KEYS)

    def add(self, **kv):
        for k, v in kv.items():
            self[k] += v

    def line(self) -> str:
        bound_by = bounds(self["flops"], self["bytes"])[2]
        return (f"{self['ms']:.3f} ms against a bound of {self['bound_ms']:.3f} ms "
                f"({bound_by}, 3xTF32 tensor cores; {self['bound_ms'] / self['ms']:.1%} of "
                f"it) and {self['bound_simt_ms']:.3f} ms (f32 CUDA cores; "
                f"{self['bound_simt_ms'] / self['ms']:.1%}); plain {self['plain_ms']:.3f} ms, "
                f"cuDNN {self['library_ms']:.3f} ms")

    def row(self) -> dict:
        return {k: self[k] for k in ("ms", "plain_ms", "bound_ms", "bound_simt_ms",
                                     "library_ms")}


def phase_parity(cfg):
    worst = 0.0
    for i, (t, c) in enumerate(stage_shapes(SEG, cfg)):
        split, concat, n, cc = chain_inputs(2, t, c, cfg, seed=100 + i)
        got = cc_mod.cond_chain(**split)
        want = cc_mod.cond_chain_plain(**split)
        d, r = rel_err(got, want)
        gotc = cc_mod.film_cond_chain(**concat)
        wantc = cc_mod.cond_chain_plain(concat["c"], concat["w0"], concat["b0"],
                                        concat["w1"], concat["b1"])
        dc, rc = rel_err(gotc, wantc)
        torch.cuda.synchronize()
        say(f"parity stage {i}: B=2 T={t} C={c} n={n} Cc={cc}: split max|d|={d:.3e} "
            f"({r:.2e} of max|ref|), concat max|d|={dc:.3e} ({rc:.2e}); "
            f"tolerance {PARITY_RTOL:.0e} of max|ref|")
        if not (r <= PARITY_RTOL and rc <= PARITY_RTOL):
            raise AssertionError(f"cond-chain kernel disagrees with its plain version at stage {i}")
        worst = max(worst, d, dc)
    return worst


def cotangent(split: dict, seed: int):
    """A cotangent g (B, T, n*2C) for the chain's output at these operands."""
    b, t, _ = split["exc"].shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, t, split["w1"].shape[2]), generator=gen, device="cuda")


def phase_k2_parity(cfg):
    """K2 against cond_chain_bwd_plain at the four training stage shapes
    (B=2), split and concat forms, every output; then autograd through
    MRFBlock.films, the kernel path against the plain chain."""
    worst = 0.0
    for i, (t, c) in enumerate(stage_shapes(SEG, cfg)):
        split, concat, n, cc = chain_inputs(2, t, c, cfg, seed=300 + i, exact_h=True)
        g = cotangent(split, seed=400 + i)
        args = {k: v for k, v in split.items() if k != "b1"}
        got = cc_mod._launch_bwd(g=g, **args)
        want = cc_mod.cond_chain_bwd_plain(g=g, **args)
        cargs = dict(exc=concat["c"], w0=concat["w0"], hbias=concat["b0"], w1=concat["w1"])
        gotc = cc_mod._launch_bwd(g=g, edge0=None, edge_t=None, **cargs)
        wantc = cc_mod.cond_chain_bwd_plain(g=g, **cargs)
        torch.cuda.synchronize()
        parts = []
        for form, a, b in (("split", got, want), ("concat", gotc, wantc)):
            if set(a) != set(b):
                raise AssertionError(f"K2 outputs {sorted(a)} differ from {sorted(b)}")
            for k in sorted(b):
                d, r = rel_err(a[k], b[k])
                parts.append(f"{form}.{k} {r:.1e}")
                worst = max(worst, d)
                if not r <= PARITY_RTOL:
                    raise AssertionError(f"K2 disagrees with cond_chain_bwd_plain at stage {i}, "
                                         f"{form} d{k}: {r:.2e} of max|ref|")
        say(f"k2 parity stage {i}: B=2 T={t} C={c}: max|d| of max|ref| " + ", ".join(parts)
            + f"; tolerance {PARITY_RTOL:.0e} of max|ref|")
        worst = max(worst, films_grad_parity(cfg, i, t, c))
    return worst


def films_grad_parity(cfg, stage, t, c):
    """torch.autograd.grad through MRFBlock.films at one stage: the kernels
    against the plain chain swapped in, on the same CUDA inputs. The inputs
    and cond_0's weights are rounded as ``chain_inputs(exact_h=True)`` does,
    with each weight-norm gain set to the norm ``weight()`` computes, so the
    effective weight is the rounded v exactly."""
    g = cfg.model.generator
    s = g.conditional_dim
    mrf = init_weights(MRFBlock(c, s + 8, tuple(g.mrf_dilations), tuple(g.mrf_kernel_sizes)),
                       seed=500 + stage).cuda()
    with torch.no_grad():
        for blk in mrf.blocks():
            conv = blk.cond_0
            conv.v.copy_(dyadic(conv.v, 1 / 256))
            conv.bias.copy_(dyadic(conv.bias, 1 / 256) + 1 / 4096)
            conv.g.copy_(torch.sqrt(torch.sum(conv.v * conv.v, dim=(1, 2))))
    gen = torch.Generator(device="cuda").manual_seed(600 + stage)
    spk = dyadic(torch.randn((2, s), generator=gen, device="cuda"), 1 / 8).requires_grad_()
    exc = dyadic(torch.randn((2, 8, t), generator=gen, device="cuda"), 1 / 8).requires_grad_()
    weights_ = [p for name, p in mrf.named_parameters() if ".cond_" in name]
    cot = None

    def grads():
        nonlocal cot
        out = torch.cat([torch.cat(f, 1) for f in mrf.films(spk, exc)], 1)
        if cot is None:
            cot = torch.randn(out.shape, generator=gen, device="cuda")
        return torch.autograd.grad(out, [spk, exc, *weights_], cot)

    before = cc_mod.bwd_launches
    got = grads()
    if cc_mod.bwd_launches != before + 1:
        raise AssertionError("MRFBlock.films did not run K2 in its backward")
    kernel_op = cc_mod.cond_chain
    cc_mod.cond_chain = cc_mod.cond_chain_plain
    try:
        want = grads()
    finally:
        cc_mod.cond_chain = kernel_op
    torch.cuda.synchronize()
    worst_r, worst_d = 0.0, 0.0
    for a, b in zip(got, want):
        d, r = rel_err(a, b)
        worst_r, worst_d = max(worst_r, r), max(worst_d, d)
    say(f"k2 films grad stage {stage}: grads of spk, exc and {len(weights_)} cond weights, "
        f"kernel path vs plain chain: worst max|d| {worst_d:.2e} ({worst_r:.2e} of max|ref|); "
        f"tolerance {PARITY_RTOL:.0e} of max|ref|")
    if not worst_r <= PARITY_RTOL:
        raise AssertionError(f"gradients through MRFBlock.films disagree at stage {stage}")
    return worst_d


def form_args(form: str, split: dict, concat: dict) -> tuple[dict, dict]:
    """(K1's kwargs, K2's kwargs without g) of ``chain_inputs``' operands in
    one form."""
    if form == "split":
        fwd_args = split
    else:
        fwd_args = dict(exc=concat["c"], w0=concat["w0"], hbias=concat["b0"],
                        w1=concat["w1"], b1=concat["b1"])
    bwd_args = {"edge0": None, "edge_t": None,
                **{k: v for k, v in fwd_args.items() if k != "b1"}}
    return fwd_args, bwd_args


def wide_case(cfg, form: str, s: int, e: int, stage: int, timed: bool, c: int | None = None):
    """K1 and K2 against their plain versions at one width and stage (C = ``c``
    where given), K2 bit for bit in a second run; with ``timed``, each
    kernel's time beside the 3xTF32 bound of its operations. One part of the
    wide-parity line."""
    t, c0 = stage_shapes(SEG, cfg)[stage]
    c = c or c0
    wcfg = copy.deepcopy(cfg)
    wcfg.model.generator.conditional_dim = s
    split, concat, n, cc = chain_inputs(2, t, c, wcfg, seed=900 + e + s + stage, exact_h=True,
                                        e=e)
    fwd_args, bwd_args = form_args(form, split, concat)
    ew = fwd_args["exc"].shape[-1]
    _, r_fwd = rel_err(cc_mod.cond_chain(**fwd_args), cc_mod.cond_chain_plain(**fwd_args))
    g = cotangent(split, seed=950 + e + s + stage)
    got = cc_mod._launch_bwd(g=g, **bwd_args)
    again = cc_mod._launch_bwd(g=g, **bwd_args)
    want = cc_mod.cond_chain_bwd_plain(g=g, **bwd_args)
    r_bwd = max(rel_err(got[k], want[k])[1] for k in want)
    torch.cuda.synchronize()
    for k in want:
        if not torch.equal(got[k], again[k]):
            raise AssertionError(f"K2 gave two different d{k} at {form} Cc={cc} E={ew} T={t}")
    part = (f"{form} Cc={cc} E={ew} T={t} 2C={2 * c} ({-(-cc // 136)} passes): K1 "
            f"{r_fwd:.1e}, K2 (worst output) {r_bwd:.1e}")
    if timed:
        k1_ms = cuda_ms(lambda: cc_mod.cond_chain(**fwd_args), iters=5, warmup=1)
        k2_ms = cuda_ms(lambda: cc_mod._launch_bwd(g=g, **bwd_args), iters=5, warmup=1)
        k1_bound = bounds(2.0 * 2 * t * (n * cc * 3 * ew + n * 2 * c * 3 * cc), 0)[0]
        k2_bound = bounds(k2_work(2, t, ew, n, cc, 2 * c)[0], 0)[0]
        part += (f"; K1 {k1_ms:.3f} ms (bound {k1_bound:.3f}), K2 {k2_ms:.3f} ms "
                 f"(bound {k2_bound:.3f})")
        if form == "concat":
            lib_fwd, lib_bwd = cudnn_chain(dict(concat, g=g), n)
            part += (f", cuDNN forward {cuda_ms(lib_fwd, iters=5):.3f} ms, backward "
                     f"{cuda_ms(lib_bwd, iters=3):.3f} ms")
    if not (r_fwd <= PARITY_RTOL and r_bwd <= PARITY_RTOL):
        raise AssertionError(f"cond-chain kernels disagree with their plain versions at "
                             f"{form} Cc={cc} E={ew} T={t}")
    del fwd_args, bwd_args, split, concat, g, got, again, want
    torch.cuda.empty_cache()
    return part


def wide_parity(cfg, card, stage: int = 1):
    """K1 and K2 against their plain versions (B=2, dyadic cond_0 operands)
    at WIDE_CASES on one training stage's (T, C) and 2C = 2 WIDE_C at the
    first stage's T, each timed, at TILED_CASES on all four stages' (timed
    at ``stage``), then K2 at GUARD_CASE with guards after its outputs."""
    for form, s, e in WIDE_CASES:
        say("wide parity: " + wide_case(cfg, form, s, e, stage, timed=True)
            + f"; tolerance {PARITY_RTOL:.0e} of max|ref| [{card}]")
    say("wide parity: " + wide_case(cfg, "split", cfg.model.generator.conditional_dim, 8, 0,
                                    timed=True, c=WIDE_C)
        + f"; tolerance {PARITY_RTOL:.0e} of max|ref| [{card}]")
    for form, s, e in TILED_CASES:
        parts = [wide_case(cfg, form, s, e, i, timed=i == stage) for i in range(STAGES)]
        say("tiled parity: " + "; ".join(parts)
            + f"; tolerance {PARITY_RTOL:.0e} of max|ref| [{card}]")
    say(guard_case(cfg, cc_mod._library()["bwd"], stage) + f" [{card}]")


def guard_case(cfg, bwd, stage: int) -> str:
    """K2 from library ``bwd`` at GUARD_CASE on ``stage``'s T through its C
    entry point, with GUARD elements after every output that must come back
    as they were, and against its plain version; the line's text."""
    t = stage_shapes(SEG, cfg)[stage][0]
    b, s, c = GUARD_CASE
    wcfg = copy.deepcopy(cfg)
    wcfg.model.generator.conditional_dim = s
    split, _, _, cc = chain_inputs(b, t, c, wcfg, seed=990, exact_h=True)
    args = {k: v for k, v in split.items() if k != "b1"}
    g = cotangent(split, seed=991)
    got = old_k2(bwd, args, g, guard=GUARD)
    want = cc_mod.cond_chain_bwd_plain(g=g, **args)
    r = max(rel_err(got[k], want[k])[1] for k in want)
    if not r <= PARITY_RTOL:
        raise AssertionError(f"K2 disagrees with its plain version at split Cc={cc} 2C={2 * c}")
    return (f"guarded K2: split B={b} Cc={cc} E=8 T={t} 2C={2 * c}, {GUARD} elements after each "
            f"output unchanged; worst output {r:.1e} of max|ref| (tolerance {PARITY_RTOL:.0e})")


def signals(seed: int, n: int = UTT) -> np.ndarray:
    """B voiced-like utterances of n samples: a gliding harmonic tone per row
    plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = rng.uniform(90, 260, (B, 1)) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 16000
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    return (0.2 * x + 0.01 * rng.standard_normal((B, n))).astype(np.float32)


def phase_slice(cfg, card, label: str = "slice") -> tuple[int, float]:
    """Full-width conversion of 16 x 71680 samples with the conv-encoder G
    of ``cfg``: K1 launches (one a decoder stage and one a bottleneck
    block), output checks, the plain-chain path, a small input against the
    CPU, ms per call and RTF, a profile. Returns the launches and the ms."""
    t0 = time.perf_counter()
    gcfg = cfg.model.generator
    g = generator_from_config(gcfg, num_classes=100, seed=0)
    conv = Converter(cfg, g, crepe_from_seed(1), decoder="viterbi")
    sigs = signals(0)
    labels = np.arange(B) % 100
    say(f"{label}: full-width conv-encoder G ({sum(p.numel() for p in g.parameters())} "
        f"parameters) and CREPE-tiny on {conv.device}, built in {time.perf_counter() - t0:.1f} s")

    # the main path: counts from 0, read right after
    cc_mod.launches = 0
    t0 = time.perf_counter()
    f0, mu = conv.pitch_batch(sigs)
    pitch_s = time.perf_counter() - t0
    mu_tgt = mu + np.float32(np.log(1.2))
    t0 = time.perf_counter()
    wav = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=0)
    convert_s = time.perf_counter() - t0
    launches = cc_mod.launches
    say(f"{label}: pitch_batch {pitch_s:.2f} s (first call), convert_batch {convert_s:.2f} s "
        f"(first call); voiced frames {float((f0 > 0).mean()):.3f}; cond-chain kernel "
        f"launches in pitch_batch + convert_batch: {launches}")
    if launches != len(gcfg.decoder_ratios) + gcfg.num_bottleneck_layers:
        raise AssertionError(f"expected one cond-chain launch per decoder stage and bottleneck "
                             f"block, got {launches}")
    if wav.shape != (B, UTT) or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        raise AssertionError(f"bad conversion output: shape {wav.shape}, "
                             f"finite {np.isfinite(wav).all()}, max|y| {np.abs(wav).max()}")

    # the same call with the plain chain in place of the kernel
    kernel_op = cc_mod.cond_chain
    cc_mod.cond_chain = cc_mod.cond_chain_plain
    try:
        wav_plain = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=0)
    finally:
        cc_mod.cond_chain = kernel_op
    d_plain = float(np.abs(wav - wav_plain).max())
    say(f"{label}: kernel path vs plain-chain path max|d|={d_plain:.3e} (tolerance "
        f"{AUDIO_ATOL})")
    if d_plain > AUDIO_ATOL:
        raise AssertionError("the kernel path and the plain path disagree")

    # a small input against the CPU path (which the tests hold against JAX)
    cpu = Converter(cfg, generator_from_config(gcfg, 100, device="cpu", seed=0),
                    crepe_from_seed(1), decoder="viterbi", device="cpu")
    small = sigs[:1, :SEG]
    sf0, smu = cpu.pitch_batch(small)
    gf0, _ = conv.pitch_batch(small)
    rng = np.random.default_rng(7)
    draws = dict(start_phase=np.float32(1.0), noise=rng.standard_normal(small.shape, np.float32))
    y_cpu = cpu.convert_batch(small, labels[:1], sf0, smu, smu, **draws)
    y_gpu = conv.convert_batch(small, labels[:1], sf0, smu, smu, **draws)
    d_cpu = float(np.abs(y_cpu - y_gpu).max())
    f0_agree = float(np.mean(np.isclose(sf0, gf0, rtol=1e-4)))
    say(f"{label}: small input (1 x {SEG}) card vs CPU: audio max|d|={d_cpu:.3e} "
        f"(tolerance {AUDIO_ATOL}), f0 frames agreeing {f0_agree:.3f}")
    if d_cpu > AUDIO_ATOL:
        raise AssertionError("the card's conversion disagrees with the CPU path")

    # conversion throughput: device-resident inputs, CUDA events
    args = [conv._tensor(a) for a in (sigs, f0, mu, mu_tgt)]
    lab = conv._tensor(labels, torch.int64)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: conv.convert_tensors(*args, lab, seed=1), iters=5, warmup=2)
    pitch_ms = cuda_ms(lambda: conv.pitch_tensors(args[0]), iters=2, warmup=1)
    audio_s = B * UTT / cfg.model.sample_rate
    say(f"{label}: convert_tensors {ms:.2f} ms per call for {B} x {UTT} samples "
        f"({audio_s:.1f} s of audio): conversion RTF {audio_s / (ms / 1e3):.1f}x real time; "
        f"pitch_tensors (Viterbi) {pitch_ms:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    profile_call(lambda: conv.convert_tensors(*args, lab, seed=1), f"one {label} call", card)
    return launches, ms


def profile_call(fn, label, card, top: int = 10):
    """Device time of one call by kernel name (torch.profiler), and the share
    of the call's wall time the card was busy."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(ev.name, [0.0, 0])
            acc[0] += ev.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy = sum(v[0] for v in by_name.values())
    if not by_name:
        say("profile: torch.profiler recorded no device kernels")
        return None
    say(f"profile: {label} {wall_ms:.2f} ms wall (profiler on), kernels busy "
        f"{busy:.2f} ms ({busy / wall_ms:.1%}), {sum(v[1] for v in by_name.values())} "
        f"kernel launches [{card}]")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"profile: {ms:8.3f} ms {ms / busy:6.1%} x{count:<5d} {name[:90]}")
    return busy


def k1_l2_bytes(b: int, t: int, e: int, n: int, cc: int, two_c: int) -> float:
    """Bytes K1's CTAs read of the weights' images in a launch, its rings'
    bulk copies from L2 (``csrc/cond_chain.cu`` fwd_plan): each CTA (tile of
    124 rows, batch row, output chunk of W columns) takes, for every block and
    pass of 136 channels, h's k-slices (2 x 4352 bytes each) and the pass's
    k-slices of W1 for its chunk (6 W 32 bytes each)."""
    npass, nkh = -(-cc // 136), -(-(3 * e + 3) // 8)
    wide = npass > 1 or nkh > 4
    w = 32 if two_c <= 32 else 64 if two_c <= 64 or wide else 128
    slices = sum(-(-min(136, cc - 136 * p) // 8) for p in range(npass))
    per_cta = n * (npass * nkh * 2 * 4352 + slices * 6 * w * 32)
    return float(-(-t // 124) * b * -(-two_c // w) * per_cta)


def k1_stage(cfg, card, b, t, c, seed, label):
    """K1 at one (B, T, C): held against its plain version, then timed beside
    its bounds, the plain version and a cuDNN sequence (a yardstick the port
    never calls). Returns (max|d|, the numbers for Totals)."""
    split, concat, n, cc = chain_inputs(b, t, c, cfg, seed=seed)
    e = split["exc"].shape[-1]
    d, r = rel_err(cc_mod.cond_chain(**split), cc_mod.cond_chain_plain(**split))
    if r > PARITY_RTOL:
        raise AssertionError(f"cond-chain kernel disagrees with its plain version at "
                             f"{label} B={b} T={t}: {r:.2e} of max|ref|")
    k_ms = cuda_ms(lambda: cc_mod.cond_chain(**split), iters=5, warmup=2)
    p_ms = cuda_ms(lambda: cc_mod.cond_chain_plain(**split), iters=3)
    w0c = concat["w0"].permute(2, 1, 0)
    w1g = concat["w1"].permute(2, 1, 0)
    cin = concat["c"].transpose(1, 2).contiguous()

    def cudnn_chain():
        h = F.leaky_relu(F.conv1d(cin, w0c, concat["b0"], padding=1), 0.2)
        return F.conv1d(h, w1g, concat["b1"], padding=1, groups=n)

    l_ms = cuda_ms(cudnn_chain, iters=3)
    flops = 2.0 * b * t * (n * cc * 3 * e + n * 2 * c * 3 * cc)
    nbytes = 4.0 * (sum(x.numel() for x in split.values()) + b * t * n * 2 * c)
    bound, bound_simt, _ = bounds(flops, nbytes)
    say(f"k1 {label} B={b} T={t} C={c}: kernel {k_ms:.3f} ms, bound {bound:.3f} ms "
        f"(3xTF32) / {bound_simt:.3f} ms (f32 CUDA cores) ({flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e9:.3f} GB; {flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s achieved), "
        f"plain {p_ms:.3f} ms, cuDNN conv1d+lrelu+grouped conv1d {l_ms:.3f} ms, "
        f"max|d| vs plain {d:.2e}; the weights' images read from L2 "
        f"{k1_l2_bytes(b, t, e, n, cc, 2 * c) / 1e9:.2f} GB a launch [{card}]")
    del split, concat
    torch.cuda.empty_cache()
    return d, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_simt_ms=bound_simt,
                   library_ms=l_ms, flops=flops, bytes=nbytes)


def phase_kernel_times(cfg, card, launches, parity_err):
    """K1 at the conversion path's four stage shapes (one call each per
    convert call) and at the train step's eight (stage, batch) shapes."""
    worst = parity_err
    paths = {"convert": Totals(), "train": Totals()}
    for i, (t, c) in enumerate(stage_shapes(UTT, cfg)):
        d, v = k1_stage(cfg, card, B, t, c, 200 + i, "convert")
        paths["convert"].add(**v)
        worst = max(worst, d)
    say(f"k1 per convert call (4 calls): {paths['convert'].line()} [{card}]")
    for bsz in (2 * B, B):
        for i, (t, c) in enumerate(stage_shapes(SEG, cfg)):
            d, v = k1_stage(cfg, card, bsz, t, c, 250 + i, "train")
            paths["train"].add(**v)
            worst = max(worst, d)
    say(f"k1 per train step (8 calls): {paths['train'].line()} [{card}]")
    conv = paths["convert"]
    return {"name": "cond_chain_fwd", "route": "cuda",
            "source": "td_vc_gan_tpu_torch/csrc/cond_chain.cu",
            "replaces": "td_vc_gan_tpu/ops/pallas/cond_chain.py:157",
            "launches": launches, "max_abs_err": worst, **conv.row(),
            "bound_by": bounds(conv["flops"], conv["bytes"])[2],
            "by_path": {k: v.row() for k, v in paths.items()}}


def train_batch(seed: int) -> dict:
    """16 x 8960 training segments; the corrupted batch is the signal plus
    seeded noise (phase 9 feeds the step the data pipeline's corruption)."""
    sig = signals(seed, SEG)
    noise = np.random.default_rng(seed + 1).standard_normal(sig.shape).astype(np.float32)
    return {"signal": torch.from_numpy(sig).cuda(),
            "corrupted": torch.from_numpy(sig + 0.05 * noise).cuda(),
            "label": torch.arange(B, device="cuda") % NUM_SPK}


def train_state(cfg):
    """The full-width models of ``cfg`` (G, D and, when its losses use it,
    the latent classifier C; random weights from seeds, as the train loop
    builds them) and their optimizers; a WavLM backbone in
    ``train.compute_dtype``."""
    g, d, c = build_models(cfg, NUM_SPK, "cuda", seed=0)
    return create_train_state(cfg, g, d, c, crepe_from_seed(2).cuda())


def phase_step(label: str, cfg, card, per_step: int, steps: int = TRAIN_STEPS,
               mu_floor: float = 0.0) -> tuple[tuple[int, int], float]:
    """The full-width f32 train step of ``cfg`` on 16 x 8960: its first step
    against the same step with the plain chain (every loss, and the first
    moments of every trainable tensor), then a warm-up and timed steps
    (CUDA events) with ``per_step`` K1 and K2 launches each; every trainable
    tensor changed, a WavLM backbone bit-identical and without gradients;
    peak memory, and one step's kernels by device time. Each first moment is
    held to STEP_MU_RTOL of its own max|ref|, or of ``mu_floor`` times its
    net's largest where that is larger; one that a norm slot cancels, to
    STEP_MU_RTOL of its net's largest. Returns the timed
    steps' (K1, K2) launches and their median ms."""
    t0 = time.perf_counter()
    state = train_state(cfg)
    step = build_train_step(cfg, state)
    batch = train_batch(10)
    nets = [("G", state.G, state.opt_g), ("D", state.D, state.opt_d)]
    if state.C is not None:
        nets.append(("C", state.C, state.opt_c))
    trainable = {f"{tag}.{n}": p.detach().clone() for tag, net, _ in nets
                 for n, p in net.named_parameters() if p.requires_grad}
    wavlm = ckpt.backbone(state.G)
    backbone = None if wavlm is None else {k: v.clone() for k, v in wavlm.state_dict().items()}
    say(f"{label}: " + ", ".join(f"{tag} {sum(p.numel() for p in net.parameters())}"
                                 for tag, net, _ in nets)
        + f" parameters ({sum(v.numel() for v in trainable.values())} trainable), batch "
        f"{B} x {SEG}, set up in {time.perf_counter() - t0:.1f} s")

    m_kernel = step(batch, torch.Generator(device="cuda").manual_seed(5))
    twin = train_state(cfg)
    twin_step = build_train_step(cfg, twin)
    kernel_op = cc_mod.cond_chain
    cc_mod.cond_chain = cc_mod.cond_chain_plain
    try:
        m_plain = twin_step(batch, torch.Generator(device="cuda").manual_seed(5))
    finally:
        cc_mod.cond_chain = kernel_op
    if set(m_kernel) != set(m_plain):
        raise AssertionError(f"{label}: the two paths log other losses")
    worst_loss = max(abs(float(m_kernel[k]) - float(m_plain[k])) /
                     max(abs(float(m_plain[k])), 1e-6) for k in m_plain)
    twins = [(twin.G, twin.opt_g), (twin.D, twin.opt_d)]
    if twin.C is not None:
        twins.append((twin.C, twin.opt_c))
    # a gradient that a norm slot cancels is rounding noise in both paths:
    # held to the tolerance of G's largest first moment, not its own
    invariant = {f"G.{n}" for n in testing.norm_invariant(state.G)}
    rel = []  # (max|d| of the scale, name, the tensor's max|ref| of its net's largest)
    for (tag, net, opt), (twin_net, twin_opt) in zip(nets, twins):
        moments = [(f"{tag}.{n}", opt.optimizer.state[p]["exp_avg"],
                    twin_opt.optimizer.state[q]["exp_avg"])
                   for (n, p), q in zip(net.named_parameters(), twin_net.parameters())
                   if p.requires_grad]
        top = max(float(b.abs().max()) for _, _, b in moments)
        for name, a, b in moments:
            own = float(b.abs().max())
            scale = top if name in invariant else max(own, mu_floor * top)
            rel.append((float((a - b).abs().max()) / max(scale, 1e-30), name, own / top))
    rel.sort(reverse=True)
    worst_mu, worst_name = rel[0][:2]
    say(f"{label}: first step, kernel path vs plain-chain path: losses worst relative "
        f"difference {worst_loss:.2e} (tolerance {STEP_LOSS_RTOL:.0e}); first moments "
        f"worst max|d| {worst_mu:.2e} of the tensor's max|ref| ({worst_name}; "
        f"{len(invariant)} tensors a norm cancels, of G's largest"
        + (f"; at least {mu_floor:.0e} of the net's largest" if mu_floor else "")
        + f") (tolerance {STEP_MU_RTOL:.0e})")
    if not (worst_loss <= STEP_LOSS_RTOL and worst_mu <= STEP_MU_RTOL):
        raise AssertionError(f"{label}: the step with the kernels disagrees with the plain "
                             f"chain; worst first moments (max|d| of max|ref|, tensor, its "
                             f"max|ref| of its net's largest): "
                             + ", ".join(f"{r:.2e} {n} {o:.1e}" for r, n, o in rel[:12]))
    del twin, twin_step, twins
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(6)
    step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], []
    cc_mod.launches = cc_mod.bwd_launches = 0
    for _ in range(steps):
        k1, k2 = cc_mod.launches, cc_mod.bwd_launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch, gen)
        end.record()
        counts.append((cc_mod.launches - k1, cc_mod.bwd_launches - k2))
        times.append((start, end))
    torch.cuda.synchronize()
    launches = (cc_mod.launches, cc_mod.bwd_launches)
    ms = sorted(s.elapsed_time(e) for s, e in times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite losses after {steps + 2} steps: {bad}")
    if any(c != (per_step, per_step) for c in counts):
        raise AssertionError(f"{label}: expected {per_step} K1 and {per_step} K2 launches per "
                             f"step, got {counts}")
    params = {f"{tag}.{n}": p for tag, net, _ in nets for n, p in net.named_parameters()}
    still = [k for k, v in trainable.items() if torch.equal(v, params[k])]
    moved = [] if backbone is None else [
        k for k, v in wavlm.state_dict().items() if not torch.equal(v, backbone[k])]
    if still or moved:
        raise AssertionError(f"{label}: trainable tensors that did not change {still[:5]}; "
                             f"backbone tensors that did {moved[:5]}")
    if backbone is not None and any(p.grad is not None for p in wavlm.parameters()):
        raise AssertionError(f"{label}: the frozen backbone has gradients")
    median = ms[len(ms) // 2]
    say(f"{label}: {steps} timed steps: median {median:.2f} ms per step (min "
        f"{ms[0]:.2f}, max {ms[-1]:.2f}), {B * 1e3 / median:.2f} segments/s; K1/K2 launches "
        f"per step {counts[0]}; G_loss {float(metrics['G_loss']):.4f}"
        + (f", C_loss {float(metrics['C_loss']):.4f}" if "C_loss" in metrics else "")
        + "; every trainable tensor changed"
        + ("" if backbone is None else
           f", the backbone bit-identical after {steps + 2} steps, with no gradient")
        + f"; peak device memory {peak:.2f} GiB [{card}]")
    profile_call(lambda: step(batch, gen), f"one {label} step", card)
    del state, step, trainable, backbone, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, median


def k2_work(b, t, e, n, cc, two_c) -> tuple[float, float]:
    """(flops, bytes) of the least the card could do for one K2 call: h
    recompute, dexc and dW0 2*3*E*n*Cc flops per (b, t) row each, da and dW1
    2*3*n*Cc*2C each; every input read once, every output written once."""
    n0, n2 = n * cc, n * two_c
    flops = 2.0 * b * t * (3 * 3 * e * n0 + 2 * 3 * n0 * two_c)
    ins = b * t * e + 3 * e * n0 + 3 * b * n0 + 3 * cc * n2 + b * t * n2
    outs = b * t * e + 3 * e * n0 + 3 * b * n0 + 3 * cc * n2 + n2
    return flops, 4.0 * (ins + outs)


# K2's launches in a call at E <= 9, the step's (E = 8), as
# cond_chain_bwd_kernel_ms times them: (name, launches); past E = 9
# k2_xdh_kernel comes before the reduce (five launches)
K2_LAUNCHES = (("k2_images_kernel", 1), ("k2_data_kernel", 1), ("k2_w1_kernel", 1),
               ("k2_reduce_kernel", 1))
# the f32 step's largest K2 call, whose workspace phase 8 prints
K2_WS_SHAPE = (2 * B, SEG, 8, 9, 136, 32)


def phase_k2_times(cfg, card, launches, parity_err):
    """K2 at the train step's eight (stage, batch) shapes: against its plain
    version, a second run bit for bit (no atomics: the same result every
    run), then kernel, bounds, plain version and cuDNN's backward of the same
    chain, and its device time by kernel (the events its library records
    between launches)."""
    totals = Totals()
    worst = parity_err
    k2_parts: dict = {}
    w1_flops = 0.0  # dW1's: 2*3*n*Cc*2C a (b, t) row
    for bsz in (2 * B, B):
        for i, (t, c) in enumerate(stage_shapes(SEG, cfg)):
            split, _, n, cc = chain_inputs(bsz, t, c, cfg, seed=700 + i, exact_h=True)
            e = split["exc"].shape[-1]
            g = cotangent(split, seed=800 + i)
            args = {k: v for k, v in split.items() if k != "b1"}
            got = cc_mod._launch_bwd(g=g, **args)
            again = cc_mod._launch_bwd(g=g, **args)
            want = cc_mod.cond_chain_bwd_plain(g=g, **args)
            for k in want:
                d, r = rel_err(got[k], want[k])
                if r > PARITY_RTOL:
                    raise AssertionError(f"K2 disagrees with its plain version at B={bsz} "
                                         f"T={t}, d{k}: {r:.2e} of max|ref|")
                if not torch.equal(got[k], again[k]):
                    raise AssertionError(f"K2 gave two different d{k} on the same inputs "
                                         f"at B={bsz} T={t}")
                worst = max(worst, d)
            del got, again, want
            k_ms = cuda_ms(lambda: cc_mod._launch_bwd(g=g, **args), iters=3, warmup=1)
            p_ms = cuda_ms(lambda: cc_mod.cond_chain_bwd_plain(g=g, **args), iters=2)
            leaves = [split[k].clone().requires_grad_() for k in ("exc", "w0", "hbias", "w1", "b1")]
            exc, w0, hbias, w1, b1 = leaves
            h = F.conv1d(exc.transpose(1, 2), w0.permute(2, 1, 0), padding=1) + hbias[..., None]
            out = F.conv1d(F.leaky_relu(h, 0.2), w1.permute(2, 1, 0), b1, padding=1, groups=n)
            gt = g.transpose(1, 2)
            l_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True),
                           iters=2)
            del h, out, leaves
            parts = event_times("bwd", "cond_chain_bwd", K2_LAUNCHES,
                                lambda: cc_mod._launch_bwd(g=g, **args))
            launched = cc_mod._library()["bwd"].cond_chain_bwd_launched()
            if launched != len(K2_LAUNCHES):
                raise AssertionError(f"K2 made {launched} launches a call at E = {e}, expected "
                                     f"{len(K2_LAUNCHES)} (no k2_xdh_kernel at E <= 9)")
            add_breakdown(k2_parts, parts)
            say(f"k2 kernels B={bsz} T={t} C={c}: {breakdown_line(parts)} [{card}]")
            flops, nbytes = k2_work(bsz, t, e, n, cc, 2 * c)
            w1_flops += 6.0 * bsz * t * n * cc * 2 * c
            bound, bound_simt, _ = bounds(flops, nbytes)
            say(f"k2 B={bsz} T={t} C={c}: kernel {k_ms:.3f} ms, bound {bound:.3f} ms "
                f"(3xTF32) / {bound_simt:.3f} ms (f32 CUDA cores) ({flops / 1e9:.1f} GFLOP, "
                f"{nbytes / 1e9:.3f} GB; {flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s "
                f"achieved), plain {p_ms:.3f} ms, cuDNN backward of conv1d+lrelu+grouped "
                f"conv1d {l_ms:.3f} ms, launches per step 1, every output bit-identical "
                f"in a second run [{card}]")
            totals.add(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_simt_ms=bound_simt,
                       library_ms=l_ms, flops=flops, bytes=nbytes)
            del split, g, args
            torch.cuda.empty_cache()
    ws = cc_mod._library()["bwd"].cond_chain_bwd_workspace(*K2_WS_SHAPE, 1)
    b_ws, t_ws, _, n_ws, cc_ws, _ = K2_WS_SHAPE
    if ws >= b_ws * t_ws * n_ws * cc_ws:
        raise AssertionError(f"K2's workspace at {K2_WS_SHAPE} ({ws} floats) holds a dh scratch")
    say(f"k2 kernels per train step (8 calls): {breakdown_line(k2_parts, 8)}; workspace at "
        f"(B, T, E, n, Cc, 2C) = {K2_WS_SHAPE}: {4 * ws / 1e9:.3f} GB (a dh scratch would be "
        f"{4 * b_ws * t_ws * n_ws * cc_ws / 1e9:.3f} GB alone) [{card}]")
    w1_ms = k2_parts["k2_w1_kernel"][0]
    w1_bound = w1_flops / PEAK_F32_TC_FLOPS * 1e3
    say(f"k2_w1_kernel per train step: {w1_ms:.3f} ms against its own bound of "
        f"{w1_bound:.3f} ms (dW1's {w1_flops / 1e12:.4f} TFLOP at "
        f"{PEAK_F32_TC_FLOPS / 1e12:.1f} TFLOP/s, 3xTF32; {w1_bound / w1_ms:.1%} of it); the "
        f"reduce {k2_parts['k2_reduce_kernel'][0]:.3f} ms [{card}]")
    say(f"k2 per train step (8 calls): {totals.line()} [{card}]")
    return {"name": "cond_chain_bwd", "route": "cuda",
            "source": "td_vc_gan_tpu_torch/csrc/cond_chain_bwd.cu",
            "replaces": "td_vc_gan_tpu/ops/pallas/cond_chain.py:221",
            "launches": launches, "max_abs_err": worst, **totals.row(),
            "bound_by": bounds(totals["flops"], totals["bytes"])[2],
            "by_kernel": {k: v[0] for k, v in k2_parts.items()}}


def utterance(rng: np.random.Generator, n: int) -> np.ndarray:
    """One voiced-like utterance, as a row of ``signals``."""
    t = np.arange(n) / 16000
    f0 = rng.uniform(90, 260) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    return (0.2 * x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def write_corpus(root: Path) -> Path:
    """The CLI phases' corpus, manifests and speaker file under ``root``."""
    rng = np.random.default_rng(20)
    train, test = [], []
    for spk in range(CORPUS_SPK):
        for j in range(CORPUS_UTT):
            sig = utterance(rng, int(rng.uniform(1.5, 4.0) * 16000))
            if (spk, j) in FLAC_FILES:
                path = root / f"s{spk:02d}_{j:03d}.flac"
                write_flac(path, sig, 16000)
            else:
                path = root / f"s{spk:02d}_{j:03d}.wav"
                write_audio(path, sig, 16000)
            if j < TRAIN_UTT:
                train.append(f"{path}|s{spk:02d}")
            elif spk in TEST_SPK:
                test.append(f"{path}|s{spk:02d}")
    (root / "train_files").write_text("\n".join(train) + "\n")
    (root / "test_files").write_text("\n".join(test) + "\n")
    with open(root / "speakers", "wb") as f:
        pickle.dump({f"s{spk:02d}": spk for spk in range(CORPUS_SPK)}, f)
    return root


def run_cli(module: str, args: list[str]) -> tuple[list[str], float]:
    """``python -m module args`` from the repository's root; (its output
    lines, wall seconds). A failure prints the output's tail and raises."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print("\n".join((proc.stdout + proc.stderr).splitlines()[-40:]), file=sys.stderr)
        raise AssertionError(f"{module} exited with {proc.returncode}")
    return proc.stdout.splitlines(), wall


class CliProcess:
    """One child process that runs CLI modules' ``main(argv)`` in turn, so
    that torch is imported once for all of them (``serve_clis`` is its
    loop). ``run`` returns what ``run_cli`` returns: the CLI's output lines
    (stdout and stderr) and its wall time inside the child. A CLI whose
    ``main`` raises, exits non-zero or returns a non-zero int fails."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.serve_clis()"], cwd=REPO,
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def run(self, module: str, args: list[str]) -> tuple[list[str], float]:
        self.proc.stdin.write(json.dumps({"module": module, "args": args}) + "\n")
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], CLI_TIMEOUT)
        reply = self.proc.stdout.readline() if ready else ""
        if not reply:
            raise AssertionError(f"{module}: no reply from the CLI process within "
                                 f"{CLI_TIMEOUT} s (exit code {self.proc.poll()})")
        reply = json.loads(reply)
        lines = reply["out"].splitlines()
        if reply["rc"] != 0:
            print("\n".join(lines[-40:]), file=sys.stderr)
            raise AssertionError(f"{module} {' '.join(args[:2])}... failed with {reply['rc']}")
        return lines, reply["wall"]

    def close(self) -> None:
        self.proc.stdin.close()
        if self.proc.wait(timeout=60) != 0:
            raise AssertionError(f"the CLI process exited with {self.proc.returncode}")


def serve_clis() -> None:
    """The loop of ``CliProcess``'s child: one JSON request per line on
    stdin, ``{"module", "args"}``; one JSON reply per line, ``{"rc", "out",
    "wall"}``, on the original stdout. The CLIs' own output is captured; the
    process's fd 1 goes to stderr meanwhile, so that what a CLI's worker
    processes write there cannot mix with the replies."""
    import contextlib
    import importlib
    import io
    import traceback

    replies = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    for request in sys.stdin:
        req = json.loads(request)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            try:
                ret = importlib.import_module(req["module"]).main(req["args"])
                rc = ret if isinstance(ret, int) and not isinstance(ret, bool) else 0
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
            except Exception:  # reported to the parent, which fails the phase
                traceback.print_exc()
                rc = 1
        replies.write(json.dumps({"rc": rc, "out": buf.getvalue(),
                                  "wall": time.perf_counter() - t0}) + "\n")
        replies.flush()


def step_lines(lines: list[str]) -> list[dict]:
    """The numbers of every logged train step line."""
    out = []
    for ln in lines:
        if ln.startswith("Epoch "):
            vals = {k: float(v) for k, v in re.findall(r"([\w/]+): (\S+?)(?:,|$)", ln)}
            vals["Itt"] = int(re.search(r"Itt (\d+)", ln).group(1))
            out.append(vals)
    return out


def one_line(lines: list[str], prefix: str) -> list[str]:
    found = [ln for ln in lines if ln.startswith(prefix)]
    if not found:
        raise AssertionError(f"no line starting {prefix!r} in the CLI's output")
    return found


class Conversion(NamedTuple):
    calls: int
    audio_s: float
    conv_s: float  # inside the CLI
    rtf: float
    k1: int
    peak: float


def convert_summary(lines: list[str], dtype: str = "float32") -> Conversion:
    """The numbers of a conversion CLI's ``Converted ...`` line; its outputs must be finite with max|y| <= 1, and each convert
    call must have launched K1 once per decoder stage."""
    summary = one_line(lines, "Converted ")[0]
    m = re.search(r"in (\d+) convert(?:_batch)? calls: ([\d.]+) s of audio in ([\d.]+) s "
                  rf"\(RTF ([\d.]+)x.*K1 launches (\d+) \({dtype}\); outputs "
                  r"(finite|NOT finite), max\|y\| ([\d.]+)", summary)
    if m is None:
        raise AssertionError(f"no conversion summary in: {summary}")
    calls, audio_s, conv_s, rtf, k1, finite, peak = m.groups()
    if finite != "finite" or float(peak) > 1.0 or int(k1) != STAGES * int(calls):
        raise AssertionError(f"conversion: outputs {finite}, max|y| {peak}, {k1} K1 launches "
                             f"in {calls} calls (expected {STAGES} each)")
    return Conversion(int(calls), float(audio_s), float(conv_s), float(rtf), int(k1),
                      float(peak))


def corruption_ms(root: Path) -> float:
    """Host time of the corruption of one batch (16 segments of 8960
    samples from the corpus, one thread), as the input pipeline runs it."""
    segs = []
    for ln in (root / "train_files").read_text().split()[:B]:
        sig, _ = read_audio(ln.split("|")[0], 16000)
        segs.append(sig[:SEG].astype(np.float32))
    t0 = time.perf_counter()
    for i, seg in enumerate(segs):
        corruption.corrupt(seg, 16000, np.random.default_rng(i))
    return (time.perf_counter() - t0) * 1e3


def phase_train_cli(root: Path, card: str, bare_median: float) -> tuple[int, int]:
    """The train CLI on the corpus, then a resume; returns its (K1, K2)
    launches."""
    run = root / "run"
    base = ["--save_path", str(run), "--data_path", str(root)]
    for o in CLI_OVERRIDES:
        base += ["--override", o]
    first, wall1 = run_cli("td_vc_gan_tpu_torch.cli.train", base)
    second, wall2 = run_cli("td_vc_gan_tpu_torch.cli.train", base + [
        "--load_path", str(run), "--max_steps", "7", "--override", "train.num_epoch=1"])
    steps = step_lines(first)
    resumed = step_lines(second)
    if [s["Itt"] for s in steps] != list(range(5)) or [s["Itt"] for s in resumed] != [5, 6]:
        raise AssertionError(f"logged steps {[s['Itt'] for s in steps]} then "
                             f"{[s['Itt'] for s in resumed]}, expected 0..4 then 5, 6")
    bad = [(s["Itt"], k) for s in steps + resumed for k, v in s.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite logged values (step, key): {bad[:5]}")
    counts = {(int(s["k1"]), int(s["k2"])) for s in steps + resumed}
    if counts != {(STAGES * 2, STAGES * 2)}:
        raise AssertionError(f"K1/K2 launches per step {sorted(counts)}, expected "
                             f"{STAGES * 2} each")
    val_k1 = [int(re.search(r"k1: (\d+)", ln).group(1)) for ln in one_line(first, "Val Epoch")]
    saved = one_line(first, "Saved epoch ")
    digest_saved = re.search(r"digest (\w+)", saved[-1]).group(1)
    digest_resumed = re.search(r"digest (\w+)", one_line(second, "Resumed train state")[0]).group(1)
    if digest_saved != digest_resumed:
        raise AssertionError("the resumed train state differs from the one saved at epoch 0")
    peaks = [float(v) for ln in one_line(first, "Saved 2 samples")
             for v in re.findall(r"(\d+\.\d+)(?:,|$)", ln.split("max|y| before writing:")[1])]
    if "not finite" in " ".join(first) or not peaks or max(peaks) > 1.0:
        raise AssertionError(f"sample dumps: max|y| {peaks}, finite "
                             f"{'not finite' not in ' '.join(first)}")
    # the reference-format export, re-imported into a fresh G
    cfg = load_config(run / "config.yaml")
    g = generator_from_config(cfg.model.generator, CORPUS_SPK, seed=123)
    ckpt.import_torch_generator(cfg, run / "step0-G.pt", g)
    blob = torch.load(run / ckpt.STATE_DIR / "epoch_0.pt", map_location="cpu",
                      weights_only=False)
    differ = [k for k, v in g.state_dict().items() if not torch.equal(v.cpu(), blob["G"][k])]
    if differ:
        raise AssertionError(f"step0-G.pt re-imported differs from the saved G: {differ[:5]}")
    done = [re.search(r"K1 (\d+) \(validation (\d+), samples (\d+)\), K2 (\d+)", ln).groups()
            for ln in (one_line(first, "Done at step")[0], one_line(second, "Done at step")[0])]
    k1 = sum(int(d[0]) for d in done)
    k2 = sum(int(d[3]) for d in done)
    loop_ms = sorted(s["step_ms"] for s in steps if 1 <= s["Itt"] <= 4)
    waits = sorted(s["data_wait_ms"] for s in steps + resumed)
    median = (loop_ms[1] + loop_ms[2]) / 2
    save = [re.search(r"in ([\d.]+) s, (\d+) bytes", ln).groups() for ln in saved]
    peak = re.search(r"peak device memory ([\d.]+) GiB", one_line(first, "Done at step")[0])
    first_loss = steps[0]["G_loss"], steps[-1]["G_loss"]
    say(f"train cli: {len(steps)} steps (epoch 0) in {wall1:.1f} s of wall time, then a "
        f"resume at step {resumed[0]['Itt']} for {len(resumed)} steps in {wall2:.1f} s; "
        f"every logged loss finite (G_loss {first_loss[0]:.4f} at step 0, {first_loss[1]:.4f} "
        f"at step 4); K1/K2 launches {STAGES * 2}/{STAGES * 2} in every step; validation K1 "
        f"launches {val_k1} per epoch ({STAGES} per utterance), sample dumps K1 "
        f"{[int(d[2]) for d in done]} (first run, resume); resumed state bit-identical to the saved one; step0-G.pt "
        f"re-imported bit-identical; sample max|y| {max(peaks):.4f}")
    say(f"train cli: loop step time, median of steps 1-4: {median:.2f} ms (min "
        f"{loop_ms[0]:.2f}, max {loop_ms[-1]:.2f}; host wall time, ending in the metrics' copy "
        f"to the host) against phase 7's bare step median {bare_median:.2f} ms "
        f"({median / bare_median - 1:+.1%}); every step's ms "
        f"{[round(s['step_ms']) for s in steps + resumed]}; wait on the input pipeline per "
        f"step: median "
        f"{waits[len(waits) // 2]:.2f} ms, max {waits[-1]:.2f} ms; host corruption of one "
        f"batch (16 x {SEG}, one thread): {corruption_ms(root):.1f} ms; checkpoint saves "
        + ", ".join(f"{float(t):.2f} s / {int(b) / 1e6:.1f} MB" for t, b in save)
        + f"; peak device memory {peak.group(1) if peak else 'not reported'} GiB [{card}]")
    return k1, k2


def pipeline_beside_step(cfg, root: Path, card: str, steps: int = 4):
    """The bare train step (phase 7's) timed in this process with one batch
    reused, then with the data pipeline's work for the next batch running
    beside each step: items made by 8 threads (the JAX package's design), by
    8 threads with the interpreter's switch interval raised tenfold, by one
    thread, and by the package's iterator (8 worker processes). What the
    pipeline costs the host-bound step, and how much of it is the
    interpreter lock."""
    state = train_state(cfg)
    step = build_train_step(cfg, state)
    ds = WaveDataset(root / "train_files", root / "speakers", sample_rate=16000,
                     max_segment_size=SEG, augment_noise=1e-9, normalization_db=-30.0,
                     data_augment=True, corrupt=True, pad_to_max=True, seed=1234)
    gen = torch.Generator(device="cuda").manual_seed(8)

    def to_card(batch):
        return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    first = to_card(collate([ds.__getitem__(i) for i in range(B)]))
    step(first, gen)  # warm-up

    def timed(start_batch):
        """Steps, each on the batch started before it, the next batch's
        items made beside it; sorted host wall times in ms."""
        out, wait = [], start_batch(0)
        for k in range(steps):
            t0 = time.perf_counter()
            batch = wait()
            wait = start_batch(k + 1)
            float(step(batch, gen)["G_loss"])
            out.append((time.perf_counter() - t0) * 1e3)
        wait()
        return sorted(out)

    def threads(pool):
        def start_batch(k):
            futs = [pool.submit(ds.__getitem__, (k * B + i) % len(ds), k) for i in range(B)]
            return lambda: to_card(collate([f.result() for f in futs]))
        return start_batch

    results = {"one batch reused": timed(lambda k: lambda: first)}
    with ThreadPoolExecutor(8) as pool:
        results["8 threads"] = timed(threads(pool))
        interval = sys.getswitchinterval()
        sys.setswitchinterval(10 * interval)
        try:
            results[f"8 threads, switch interval {10 * interval * 1e3:g} ms"] = timed(
                threads(pool))
        finally:
            sys.setswitchinterval(interval)
    with ThreadPoolExecutor(1) as pool:
        results["1 thread"] = timed(threads(pool))
    t0 = time.perf_counter()
    it = make_train_iterator(ds, B, num_workers=8, seed=1234)
    try:
        next(it)  # the workers' start
        start_s = time.perf_counter() - t0
        results["8 processes (the package's iterator)"] = timed(
            lambda k: lambda: to_card(next(it)[1]))
    finally:
        it.close()
    del state, step
    torch.cuda.empty_cache()
    bare = results["one batch reused"][steps // 2]
    say(f"pipeline beside the step: {steps} bare steps each (host wall time, ending in a "
        f"loss's copy to the host), median and min/max, the next batch made beside each: "
        + "; ".join(f"{name} {v[steps // 2]:.2f} ms ({v[steps // 2] / bare - 1:+.1%}; "
                    f"{v[0]:.0f}/{v[-1]:.0f})" for name, v in results.items())
        + f"; the iterator's first batch (its workers' start) {start_s:.2f} s [{card}]")


def phase_generate_cli(root: Path, card: str) -> int:
    """The conversion CLI on phase 9's run; returns its K1 launches."""
    out = root / "converted"
    lines, wall = run_cli("td_vc_gan_tpu_torch.cli.generate_with_target",
                          ["--save_path", str(out), "--load_path", str(root / "run"),
                           "--data_path", str(root)])
    calls, audio_s, conv_s, rtf, k1, peak = convert_summary(lines)
    n_utt = len(TEST_SPK)
    convs = sorted(out.glob("*-conv.wav"))
    origs = sorted(out.glob("*-X-orig.wav"))
    log = (out / "conv_log.txt").read_text().splitlines()
    if (len(convs), len(origs), len(log)) != (n_utt * n_utt, n_utt, n_utt * n_utt):
        raise AssertionError(f"{len(convs)} conversions, {len(origs)} originals, "
                             f"{len(log)} log lines; expected {n_utt * n_utt}, {n_utt}, "
                             f"{n_utt * n_utt}")
    if calls != n_utt:
        raise AssertionError(f"{calls} convert_batch calls, expected {n_utt}")
    say(f"generate cli: {n_utt} utterances x {n_utt} speakers, {len(convs)} conversions, "
        f"{len(origs)} originals, conv_log.txt of {len(log)} lines; outputs finite, max|y| "
        f"{float(peak):.4f}; K1 launches {k1} in {calls} convert_batch calls ({STAGES} each); "
        f"{float(audio_s):.2f} s of audio out in {float(conv_s):.2f} s inside the CLI (RTF "
        f"{float(rtf):.1f}x, pitch and file I/O included), {wall:.1f} s of wall time for the "
        f"whole process (RTF {float(audio_s) / wall:.2f}x) [{card}]")
    return int(k1)


def cli_chain_parity(cfg, root: Path, card: str) -> float:
    """K1 against its plain version at the chain shapes the CLI phases gave
    it: B=1 at the 8960-multiple bucket of each test utterance (validation
    and sample dumps, phase 9) and B=len(TEST_SPK) at its 320-multiple
    bucket (one convert_batch call of phase 10), at every decoder stage,
    split form, on seeded operands. Returns the worst max|d|."""
    bucket = inspect.signature(Converter).parameters["bucket_multiple"].default
    lengths = [read_audio(ln.split("|")[0], cfg.model.sample_rate)[0].shape[0]
               for ln in (root / "test_files").read_text().split()]
    cases = sorted({("train_cli", 1, len(_pad_bucket(np.zeros(n, np.float32),
                                                     cfg.test.max_segment)))
                    for n in lengths})
    cases += sorted({("generate_cli", len(TEST_SPK), -(-n // bucket) * bucket)
                     for n in lengths})
    worst, parts = 0.0, []
    for j, (path, b, m) in enumerate(cases):
        for i, (t, c) in enumerate(stage_shapes(m, cfg)):
            split, _, _, _ = chain_inputs(b, t, c, cfg, seed=1000 + 10 * j + i)
            d, r = rel_err(cc_mod.cond_chain(**split), cc_mod.cond_chain_plain(**split))
            torch.cuda.synchronize()
            if not r <= PARITY_RTOL:
                raise AssertionError(f"K1 disagrees with its plain version at the {path} "
                                     f"shape B={b} T={t} C={c}: {r:.2e} of max|ref|")
            worst = max(worst, d)
            del split
        parts.append(f"{path} B={b} x {m} samples")
    torch.cuda.empty_cache()
    say(f"cli shapes parity: K1 against its plain version at every stage of "
        + ", ".join(parts) + f": worst max|d| {worst:.3e}; tolerance {PARITY_RTOL:.0e} of "
        f"max|ref| [{card}]")
    return worst


def wavlm_cfg(cfg):
    """``cfg`` with the WavLM encoder: wavlm-stage2_2 (the JAX package's
    flagship defaults)."""
    out = copy.deepcopy(cfg)
    out.model.generator.encoder_model = "wavlm"
    return out


def phase_wavlm_convert(cfg, card):
    """The full-width wavlm-stage2_2 Converter (WavLM-Large from a seed, CREPE
    tiny) on phase 4's batch: K1 launches, output checks, the plain-chain
    path, the backbone on the card against the CPU's, times and the
    backbone's share of a profiled call."""
    wcfg = wavlm_cfg(cfg)
    t0 = time.perf_counter()
    g = generator_from_config(wcfg.model.generator, num_classes=100, seed=0)
    conv = Converter(wcfg, g, crepe_from_seed(1), decoder="viterbi")
    n_backbone = sum(p.numel() for p in g.encoder.wavlm.parameters())
    say(f"wavlm convert: full-width wavlm-stage2_2 G ({sum(p.numel() for p in g.parameters())} "
        f"parameters, {n_backbone} in the frozen WavLM-Large from a seed) and CREPE-tiny, "
        f"built in {time.perf_counter() - t0:.1f} s")
    sigs = signals(0)
    labels = np.arange(B) % 100

    # the main path: counts from 0, read right after
    cc_mod.launches = 0
    f0, mu = conv.pitch_batch(sigs)
    mu_tgt = mu + np.float32(np.log(1.2))
    wav = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=0)
    launches = cc_mod.launches
    if launches != STAGES:
        raise AssertionError(f"expected {STAGES} K1 launches per convert call, got {launches}")
    if wav.shape != (B, UTT) or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        raise AssertionError(f"bad wavlm conversion output: shape {wav.shape}, finite "
                             f"{np.isfinite(wav).all()}, max|y| {np.abs(wav).max()}")
    kernel_op = cc_mod.cond_chain
    cc_mod.cond_chain = cc_mod.cond_chain_plain
    try:
        wav_plain = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=0)
    finally:
        cc_mod.cond_chain = kernel_op
    d_plain = float(np.abs(wav - wav_plain).max())
    if d_plain > AUDIO_ATOL:
        raise AssertionError(f"wavlm conversion: the kernel path and the plain path differ by "
                             f"{d_plain:.3e}")

    # the backbone on the card against the CPU's, one 1 s utterance
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    one = torch.from_numpy(np.pad(sigs[:1, :16000], ((0, 0), (160, 0))))
    with torch.inference_mode():
        f_gpu = g.encoder.wavlm(one.cuda()).cpu()
        f_cpu = copy.deepcopy(g.encoder.wavlm).cpu()(one)
    d_feat, r_feat = rel_err(f_gpu, f_cpu)
    if not r_feat <= FEATURE_RTOL:
        raise AssertionError(f"WavLM features on the card differ from the CPU's by {r_feat:.2e} "
                             f"of max|ref|")
    say(f"wavlm convert: K1 launches in pitch_batch + convert_batch {launches}; output finite, "
        f"max|y| {np.abs(wav).max():.4f}; kernel path vs plain-chain path max|d|={d_plain:.3e} "
        f"(tolerance {AUDIO_ATOL}); WavLM features (1 x 16160 samples, {tuple(f_cpu.shape)}) "
        f"card vs CPU max|d| {d_feat:.3e} ({r_feat:.2e} of max|ref| {float(f_cpu.abs().max()):.3f}; "
        f"tolerance {FEATURE_RTOL:.0e}; TF32 off)")

    args = [conv._tensor(a) for a in (sigs, f0, mu, mu_tgt)]
    lab = conv._tensor(labels, torch.int64)
    padded = torch.nn.functional.pad(args[0], (160, 0))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: conv.convert_tensors(*args, lab, seed=1), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pitch_ms = cuda_ms(lambda: conv.pitch_tensors(args[0]), iters=2, warmup=1)
    with torch.inference_mode():
        backbone_ms = cuda_ms(lambda: g.encoder.wavlm(padded), iters=5, warmup=1)
    audio_s = B * UTT / wcfg.model.sample_rate
    say(f"wavlm convert: convert_tensors {ms:.2f} ms per call for {B} x {UTT} samples "
        f"({audio_s:.1f} s of audio): conversion RTF {audio_s / (ms / 1e3):.1f}x real time; "
        f"the backbone alone {backbone_ms:.2f} ms ({backbone_ms / ms:.1%} of the call); "
        f"pitch_tensors (Viterbi) {pitch_ms:.2f} ms; peak device memory {peak:.2f} GiB [{card}]")
    busy = profile_call(lambda: conv.convert_tensors(*args, lab, seed=1),
                        "one wavlm convert call", card)
    with torch.inference_mode():
        busy_b = profile_call(lambda: g.encoder.wavlm(padded), "the WavLM backbone alone", card,
                              top=6)
    if busy and busy_b:
        say(f"wavlm convert: the backbone's share of a profiled convert call: {busy_b:.2f} of "
            f"{busy:.2f} ms of kernels ({busy_b / busy:.1%}) [{card}]")
    del conv, g, args, padded
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def write_wavlm_checkpoint(root: Path) -> tuple[Path, str, float]:
    """WavLM-Large from a seed, written as a Microsoft ``WavLM-Large.pt``;
    (its path, the digest of its tensors in the loader's table order, the
    seconds the write took)."""
    blob = microsoft_wavlm_checkpoint(init_weights(WavLM(WavLMConfig()), 11))
    digest = backbone_digest(blob["model"][ms] for ms, _ in key_table(WavLMConfig()))
    path = root / "WavLM-Large.pt"
    t0 = time.perf_counter()
    torch.save(blob, path)
    return path, digest, time.perf_counter() - t0


def phase_wavlm_clis(root: Path, card: str) -> tuple[int, int, int]:
    """The train CLI with --wavlm_checkpoint on phase 9's corpus (epoch 0,
    a save, a resume for 2 steps), then the conversion CLI on that run; the
    backbone's digest after loading, after the resume and in the conversion
    CLI against the written file's. Returns (train K1, train K2, convert K1)."""
    ckpt_path, digest, write_s = write_wavlm_checkpoint(root)
    size = ckpt_path.stat().st_size
    run = root / "wavlm_run"
    base = ["--save_path", str(run), "--data_path", str(root),
            "--wavlm_checkpoint", str(ckpt_path)]
    for o in WAVLM_CLI_OVERRIDES:
        base += ["--override", o]
    first, wall1 = run_cli("td_vc_gan_tpu_torch.cli.train", base)
    second, wall2 = run_cli("td_vc_gan_tpu_torch.cli.train", base + [
        "--load_path", str(run), "--max_steps", "7", "--override", "train.num_epoch=1"])
    steps, resumed = step_lines(first), step_lines(second)
    if [s["Itt"] for s in steps] != list(range(5)) or [s["Itt"] for s in resumed] != [5, 6]:
        raise AssertionError(f"wavlm CLI: logged steps {[s['Itt'] for s in steps]} then "
                             f"{[s['Itt'] for s in resumed]}, expected 0..4 then 5, 6")
    bad = [(s["Itt"], k) for s in steps + resumed for k, v in s.items() if not np.isfinite(v)]
    counts = {(int(s["k1"]), int(s["k2"])) for s in steps + resumed}
    if bad or counts != {(STAGES * 2, STAGES * 2)}:
        raise AssertionError(f"wavlm CLI: non-finite values {bad[:5]}, K1/K2 per step "
                             f"{sorted(counts)}")
    digests = {
        "loaded": one_line(first, "Loaded WavLM backbone from")[0],
        "resumed": one_line(second, "Resumed train state")[0],
        "end of training": one_line(second, "Done at step")[0],
    }
    gen_lines, gen_wall = run_cli("td_vc_gan_tpu_torch.cli.generate_with_target",
                                  ["--save_path", str(root / "wavlm_converted"),
                                   "--load_path", str(run), "--data_path", str(root)])
    digests["conversion CLI"] = one_line(gen_lines, "WavLM backbone from train state epoch 0")[0]
    wrong = {k: ln for k, ln in digests.items() if f"digest {digest}" not in ln}
    if wrong:
        raise AssertionError(f"the backbone's digest differs from the written file's "
                             f"({digest}) at {sorted(wrong)}: {list(wrong.values())[:2]}")
    calls, audio_s, conv_s, rtf, gen_k1, peak_y = convert_summary(gen_lines)
    saved = one_line(first, "Saved epoch ")[0]
    save_s, save_b = re.search(r"in ([\d.]+) s, (\d+) bytes", saved).groups()
    peak = re.search(r"peak device memory ([\d.]+) GiB", one_line(first, "Done at step")[0])
    loop_ms = sorted(s["step_ms"] for s in steps if s["Itt"] >= 1)
    done = [re.search(r"K1 (\d+) \(validation (\d+), samples (\d+)\), K2 (\d+)", ln).groups()
            for ln in (one_line(first, "Done at step")[0], digests["end of training"])]
    say(f"wavlm cli: WavLM-Large.pt from a seed ({size / 1e9:.3f} GB, Microsoft layout, "
        f"conv_feature_layers as a string) written in {write_s:.2f} s; train CLI "
        f"--wavlm_checkpoint: {len(steps)} steps (epoch 0) in {wall1:.1f} s of wall time, a "
        f"resume at step 5 for {len(resumed)} steps in {wall2:.1f} s; every logged loss "
        f"finite; K1/K2 {STAGES * 2}/{STAGES * 2} in every step; the backbone's digest equal to "
        f"the file's after loading, after the resume, at the end of training and in the "
        f"conversion CLI ({digest[:16]}...)")
    say(f"wavlm cli: loop step time, median of steps 1-4 {(loop_ms[1] + loop_ms[2]) / 2:.2f} ms "
        f"(min {loop_ms[0]:.2f}, max {loop_ms[-1]:.2f}); checkpoint save {float(save_s):.2f} s "
        f"for {int(save_b) / 1e9:.3f} GB (train state with the backbone, and step0-*.pt); "
        f"peak device memory {peak.group(1) if peak else 'not reported'} GiB; conversion CLI: "
        f"{calls} convert_batch calls, K1 {gen_k1}, outputs finite, max|y| "
        f"{float(peak_y):.4f}, {float(audio_s):.2f} s of audio in {float(conv_s):.2f} s (RTF "
        f"{float(rtf):.1f}x inside the CLI), {gen_wall:.1f} s of wall time [{card}]")
    return (sum(int(d[0]) for d in done), sum(int(d[3]) for d in done), int(gen_k1))


# ---------------------------------------------------------------------------
# bf16 mixed precision (train.compute_dtype: bfloat16): phases 14-17
# ---------------------------------------------------------------------------


def bf16_cfg(cfg, encoder: str = "conv"):
    """``cfg`` in bf16 mixed precision with the given encoder."""
    out = copy.deepcopy(cfg)
    out.train.compute_dtype = "bfloat16"
    out.model.generator.encoder_model = encoder
    return out


def bf16_bounds(flops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of bf16 work: the larger of its operations at the
    card's dense bf16 tensor-core rate and its bytes at its memory rate."""
    op_s, byte_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes"


def ulp_parity(label: str, got, want) -> tuple[float, float, float]:
    """A bf16 kernel output against its plain version (same dtype): the share
    of elements more than one bf16 ulp of the plain value apart, max|d| of
    max|plain|, and max|d|; raises beyond BF16_ULP_SHARE or BF16_MAX_REL."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    d = (g - w).abs()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(w), e - 8))
    share = float((d > ulp).float().mean())
    dmax = float(d.max())
    rel = dmax / max(float(w.abs().max()), 1e-30)
    if not (share <= BF16_ULP_SHARE and rel <= BF16_MAX_REL):
        raise AssertionError(f"{label}: {share:.2e} of elements beyond one bf16 ulp (limit "
                             f"{BF16_ULP_SHARE:.0e}), max|d| {rel:.2e} of max|plain| (limit "
                             f"{BF16_MAX_REL:.2e})")
    return share, rel, dmax


def bf16_chain_parity(cfg, card):
    """K1-bf16 and K2-bf16 against their plain bf16 versions at the four
    training stage shapes (B=2), split and concat forms, every output, K2-bf16
    bit for bit in a second run; then at the wide widths (several passes of
    136 columns of h), excitation widths off 8 and BF16_WIDE_CASES; returns
    (worst K1 max|d|, worst K2 max|d|). The
    operands are those of ``chain_inputs(exact_h=True)`` rounded to bf16 (the
    rounded values are bf16 already), so h is exact in any summation order
    and the leaky_relu slope K2 takes at each element is the plain version's:
    with unrounded inputs an h within rounding of 0 takes the other slope in
    one of them, which moves dexc by up to 0.8 da w0 (seen at 1.8e-2 of
    max|dexc| in the concat form)."""
    w1 = w2 = 0.0
    worst_share = worst_rel = 0.0
    cases = [("split" if f == 0 else "concat", cfg.model.generator.conditional_dim, 8, i, None)
             for i in range(STAGES) for f in (0, 1)]
    cases += [(form, s, e, i, None) for form, s, e in BF16_TILED_CASES for i in range(STAGES)]
    cases += [(form, s, e, 0, c) for form, s, e, c in BF16_WIDE_CASES]
    libs = cc_mod._library()
    tiles = set()
    for form, s, e, i, c in cases:
        t, c0 = stage_shapes(SEG, cfg)[i]
        c = c or c0
        wcfg = copy.deepcopy(cfg)
        wcfg.model.generator.conditional_dim = s
        split, concat, n, cc = chain_inputs(2, t, c, wcfg, seed=1400 + s + 10 * i, e=e,
                                            exact_h=True, dtype=torch.bfloat16)
        fwd, bwd = form_args(form, split, concat)
        ew = fwd["exc"].shape[-1]
        cc_p, c2_p = cc_mod._padded_widths("bwd_bf16", cc, 2 * c)
        tiles.add((form, cc, ew, 2 * c,
                   libs["fwd_bf16"].cond_chain_fwd_bf16_tile(
                       cc_mod._padded_e("fwd_bf16", ew),
                       *cc_mod._padded_widths("fwd_bf16", cc, 2 * c)),
                   libs["bwd_bf16"].cond_chain_bwd_bf16_rows(2, t, ew, n, cc_p, c2_p)))
        sh, rel, d = ulp_parity(f"K1-bf16 {form} Cc={cc} T={t} 2C={2 * c}",
                                cc_mod.cond_chain(**fwd), cc_mod.cond_chain_plain(**fwd))
        w1 = max(w1, d)
        if form == "concat" and (form, s, e) in {x[:3] for x in BF16_WIDE_CASES}:
            lib_fwd = cudnn_chain(dict(concat, g=cotangent(split, 0).to(torch.bfloat16)), n)[0]
            say(f"bf16 wide: K1-bf16 concat B=2 T={t} Cc=E={cc} 2C={2 * c} n={n}: kernel "
                f"{cuda_ms(lambda: cc_mod.cond_chain(**fwd), iters=5, warmup=1):.3f} ms, cuDNN "
                f"bf16 {cuda_ms(lib_fwd, iters=5):.3f} ms [{card}]")
        worst_share, worst_rel = max(worst_share, sh), max(worst_rel, rel)
        g = cotangent(split, seed=1500 + s + i).to(torch.bfloat16)
        got = cc_mod._launch_bwd(g=g, **bwd)
        again = cc_mod._launch_bwd(g=g, **bwd)
        want = cc_mod.cond_chain_bwd_plain(g=g, **bwd)
        for k in want:
            sh, rel, d = ulp_parity(f"K2-bf16 {form} Cc={cc} T={t} 2C={2 * c} d{k}", got[k],
                                    want[k])
            if not torch.equal(got[k], again[k]):
                raise AssertionError(f"K2-bf16 gave two different d{k} on the same inputs")
            w2 = max(w2, d)
            worst_share, worst_rel = max(worst_share, sh), max(worst_rel, rel)
        del split, concat, fwd, bwd, got, again, want
    torch.cuda.synchronize()
    # every case in one tile (124 rows), and the passes of 136 columns the
    # wide cases take
    if {(a, b) for *_, a, b in tiles} != {(124, 124)}:
        raise AssertionError(f"the parity cases took tiles {sorted(tiles)}, expected 124 rows")
    passes = sorted({-(-cc // 136) for _, cc, *_ in tiles})
    if passes[0] != 1 or passes[-1] < 9:
        raise AssertionError(f"the parity cases took {passes} passes of 136 columns")
    default = (cfg.model.generator.conditional_dim + 8, 8)
    say(f"bf16 parity: K1-bf16 and K2-bf16 (every output, a second run bit for bit) against "
        f"their plain bf16 versions at the 4 training stages (B=2, split and concat) and at "
        + ", ".join(f"{f} Cc={cc} E={ew} 2C={c2} ({-(-cc // 136)} passes)"
                    for f, cc, ew, c2, _, _ in sorted(tiles) if (cc, ew) != default or c2 > 256)
        + f": worst share beyond one bf16 ulp {worst_share:.2e} (limit {BF16_ULP_SHARE:.0e}), "
        f"worst max|d| {worst_rel:.2e} of max|plain| (limit {BF16_MAX_REL:.2e}) [{card}]")
    return w1, w2


def k1_bf16_stage(cfg, card, b, t, c, seed, label):
    """K1-bf16 at one (B, T, C): parity, then its time beside its bf16 bounds,
    the plain bf16 version, K1 (f32) and cuDNN's bf16 sequence."""
    split, concat, n, cc = chain_inputs(b, t, c, cfg, seed=seed, dtype=torch.bfloat16)
    e = split["exc"].shape[-1]
    sh, rel, d = ulp_parity(f"K1-bf16 {label} B={b} T={t}", cc_mod.cond_chain(**split),
                            cc_mod.cond_chain_plain(**split))
    k_ms = cuda_ms(lambda: cc_mod.cond_chain(**split), iters=5, warmup=2)
    p_ms = cuda_ms(lambda: cc_mod.cond_chain_plain(**split), iters=2)
    f32 = {k: v.float() for k, v in split.items()}
    f_ms = cuda_ms(lambda: cc_mod.cond_chain(**f32), iters=3, warmup=1)
    del f32
    w0c, w1g = concat["w0"].permute(2, 1, 0), concat["w1"].permute(2, 1, 0)
    cin = concat["c"].transpose(1, 2).contiguous()

    def cudnn_chain():
        h = F.leaky_relu(F.conv1d(cin, w0c, concat["b0"], padding=1), 0.2)
        return F.conv1d(h, w1g, concat["b1"], padding=1, groups=n)

    l_ms = cuda_ms(cudnn_chain, iters=3)
    flops = 2.0 * b * t * (n * cc * 3 * e + n * 2 * c * 3 * cc)
    nbytes = 2.0 * (sum(x.numel() for x in split.values()) + b * t * n * 2 * c)
    bound, by = bf16_bounds(flops, nbytes)
    say(f"k1-bf16 {label} B={b} T={t} C={c}: kernel {k_ms:.3f} ms, bound {bound:.3f} ms "
        f"({by}: {flops / 1e9:.1f} GFLOP at {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms, {nbytes / 1e9:.3f} GB at 3.35 TB/s "
        f"{nbytes / PEAK_BYTES * 1e3:.3f} ms; {bound / k_ms:.1%} of it), plain bf16 "
        f"{p_ms:.3f} ms, K1 (f32) {f_ms:.3f} ms, cuDNN bf16 conv1d+lrelu+grouped conv1d "
        f"{l_ms:.3f} ms; vs plain: {sh:.2e} beyond one ulp, max|d| {d:.2e} [{card}]")
    del split, concat, cin
    torch.cuda.empty_cache()
    return d, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, library_ms=l_ms, f32_ms=f_ms,
                   flops=flops, bytes=nbytes)


def k2_bf16_stage(cfg, card, b, t, c, seed):
    """K2-bf16 at one (B, T, C): parity and a second run bit for bit, then its
    time beside its bf16 bounds, the plain bf16 version, K2 (f32) and cuDNN's
    bf16 backward of the same chain."""
    split, _, n, cc = chain_inputs(b, t, c, cfg, seed=seed, exact_h=True, dtype=torch.bfloat16)
    e = split["exc"].shape[-1]
    g = cotangent(split, seed=seed + 50).to(torch.bfloat16)
    args = {k: v for k, v in split.items() if k != "b1"}
    got = cc_mod._launch_bwd(g=g, **args)
    again = cc_mod._launch_bwd(g=g, **args)
    want = cc_mod.cond_chain_bwd_plain(g=g, **args)
    worst_sh = worst_d = 0.0
    for k in want:
        sh, _, d = ulp_parity(f"K2-bf16 B={b} T={t} d{k}", got[k], want[k])
        if not torch.equal(got[k], again[k]):
            raise AssertionError(f"K2-bf16 gave two different d{k} at B={b} T={t}")
        worst_sh, worst_d = max(worst_sh, sh), max(worst_d, d)
    del got, again, want
    torch.cuda.empty_cache()
    k_ms = cuda_ms(lambda: cc_mod._launch_bwd(g=g, **args), iters=3, warmup=1)
    p_ms = cuda_ms(lambda: cc_mod.cond_chain_bwd_plain(g=g, **args), iters=1)
    f32 = {k: (v.float() if v is not None else None) for k, v in args.items()}
    g32 = g.float()
    f_ms = cuda_ms(lambda: cc_mod._launch_bwd(g=g32, **f32), iters=2, warmup=1)
    del f32, g32
    torch.cuda.empty_cache()
    leaves = [split[k].clone().requires_grad_() for k in ("exc", "w0", "hbias", "w1", "b1")]
    exc, w0, hbias, w1, b1 = leaves
    h = F.conv1d(exc.transpose(1, 2), w0.permute(2, 1, 0), padding=1) + hbias[..., None]
    out = F.conv1d(F.leaky_relu(h, 0.2), w1.permute(2, 1, 0), b1, padding=1, groups=n)
    gt = g.transpose(1, 2)
    l_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True), iters=2)
    del h, out, leaves
    parts = event_times("bwd_bf16", "cond_chain_bwd_bf16", tuple((k, 1) for k in K2B_LAUNCHES),
                        lambda: cc_mod._launch_bwd(g=g, **args))
    say(f"k2-bf16 kernels B={b} T={t} C={c}: {breakdown_line(parts)} [{card}]")
    flops, nbytes4 = k2_work(b, t, e, n, cc, 2 * c)
    nbytes = nbytes4 / 2  # every input and output is bf16
    bound, by = bf16_bounds(flops, nbytes)
    say(f"k2-bf16 B={b} T={t} C={c}: kernel {k_ms:.3f} ms, bound {bound:.3f} ms ({by}: "
        f"{flops / 1e9:.1f} GFLOP at {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms, {nbytes / 1e9:.3f} GB at 3.35 TB/s "
        f"{nbytes / PEAK_BYTES * 1e3:.3f} ms; {bound / k_ms:.1%} of it), plain bf16 "
        f"{p_ms:.3f} ms, K2 (f32) {f_ms:.3f} ms, cuDNN bf16 backward {l_ms:.3f} ms; vs plain "
        f"(every output): {worst_sh:.2e} beyond one ulp, max|d| {worst_d:.2e}; bit-identical "
        f"in a second run [{card}]")
    del split, g, args
    torch.cuda.empty_cache()
    return worst_d, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, library_ms=l_ms, f32_ms=f_ms,
                         flops=flops, bytes=nbytes, parts=parts,
                         w1_flops=2.0 * b * t * 3 * n * cc * 2 * c)


# K2's and K2-bf16's kernels, by the names the profiler gives them (demangled,
# or not: "...15k2b_data_kernelENS_8DataArgsE"), template arguments kept
K2B_KERNELS = re.compile(r"(w_images_kernel|k1_(?:f32|images)_kernel|k2b?_[A-Za-z0-9]+?_kernel)"
                         r"(<[^>]*>|I(?:L[ib]\d+E)+E)?")
# the batch-64 step's largest K2-bf16 call, whose workspace phase 14 prints,
# and the wide route's (concat E = Cc = 600, wide_shapes' last), with its
# scratch of a
K2B_WS_SHAPE = (2 * B64, SEG, 8, 9, 136, 32)
K2B_WIDE_WS_SHAPE = (2, 2240, 600, 9, 600, 128)


def k2b_label(name: str) -> str | None:
    """'k2_w1_kernel<64>' for a profiler kernel name of K2's or K2-bf16's
    (or K1's: 'k1_f32_kernel<32,0>', 'k1_images_kernel'), else None."""
    m = K2B_KERNELS.search(name)
    if m is None:
        return None
    targs = [{"true": "1", "false": "0"}.get(x, x)
             for x in re.findall(r"\d+|true|false", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(targs)}>" if targs else "")


# K2-bf16's launches in a call at E = 8, the step's, as
# cond_chain_bwd_bf16_kernel_ms orders them (past E = 8 k2b_xdh_kernel before
# the reduce)
K2B_LAUNCHES = ("w_images_kernel", "k2b_data_kernel<1>", "k2b_w1_kernel", "k2b_reduce_kernel")


def event_times(lib_name: str, prefix: str, launches: tuple, fn) -> dict:
    """{kernel: [device ms, launches]} of one call of ``fn`` (this tree's
    K2 or K2-bf16, warm) from the events its library (``lib_name``) records
    between its launches (``{prefix}_time_kernels``, ``{prefix}_kernel_ms``;
    each kernel's time from the end of the launch before it); ``launches``
    names them, as (name, launches). Late in the full run a torch.profiler
    session could record no device event at all, so phases 8 and 14 do not
    depend on it."""
    lib = cc_mod._library()[lib_name]
    on, get = getattr(lib, f"{prefix}_time_kernels"), getattr(lib, f"{prefix}_kernel_ms")
    on.argtypes = [ctypes.c_int]
    get.argtypes = [ctypes.POINTER(ctypes.c_float)]
    ms = (ctypes.c_float * 5)()
    if on(1):
        raise RuntimeError(f"{prefix} could not make its timing events")
    try:
        fn()
        torch.cuda.synchronize()
        if get(ms):
            raise RuntimeError(f"{prefix}'s timing events gave no time")
    finally:
        on(0)
    return {name: [float(ms[k]), count] for k, (name, count) in enumerate(launches)}


def kernel_breakdown(fn, attempts: int = 3) -> dict:
    """{kernel: [device ms, launches]} of K2-bf16's (or K2's, K1's) kernels in one call of
    ``fn`` (torch.profiler; ``fn`` warm), for ``--ab``, whose earlier
    library has no timing events; it runs first in its process, where the
    profiler works. The profiler starts tracing the card some time after its
    session opens and can lose the last records (a short call lost its
    first kernels, once its last two; a session has lost its first spin
    however long): the call sits between spins of the card (two before it,
    the first ~20 ms, 4x longer at each retry), and a session counts only
    when its first and last device events are spins."""
    seen: list[str] = []
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(35e6 * 4 ** attempt))
            torch.cuda._sleep(int(1e6))
            fn()
            torch.cuda._sleep(int(1e6))
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        seen = [ev.name for ev in evs]
        if len(evs) < 3 or k2b_label(seen[0]) or k2b_label(seen[-1]):
            continue
        out: dict[str, list] = {}
        for ev in evs:
            label = k2b_label(ev.name)
            if label:
                acc = out.setdefault(label, [0.0, 0])
                acc[0] += ev.time_range.elapsed_us() / 1e3
                acc[1] += 1
        if out:
            return out
    raise AssertionError(f"the profiler did not record K2-bf16's call whole in {attempts} "
                         f"sessions; the last saw {len(seen)} device events: "
                         f"{[x[:80] for x in seen[:8]]}")


def add_breakdown(total: dict, part: dict) -> None:
    for name, (ms, count) in part.items():
        acc = total.setdefault(name, [0.0, 0])
        acc[0] += ms
        acc[1] += count


def breakdown_line(parts: dict, calls: int = 1) -> str:
    """'kernel ms xN, ...' by time, then the launches per call."""
    return (", ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in
                      sorted(parts.items(), key=lambda kv: -kv[1][0]))
            + f"; {sum(n for _, n in parts.values()) // calls} launches a call")


def bf16_row(name, source, replaces, sums: dict, err: float) -> dict:
    """A kernel-table row from summed per-shape numbers."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err,
            **{k: sums[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "f32_ms")},
            "bound_by": bf16_bounds(sums["flops"], sums["bytes"])[1],
            "bound_flops_ms": sums["flops"] / PEAK_BF16_FLOPS * 1e3,
            "bound_bytes_ms": sums["bytes"] / PEAK_BYTES * 1e3}


def phase_bf16_kernels(cfg, card):
    """Phase 14: K1-bf16 and K2-bf16 parity, then their times at the bf16
    conversion's four stage shapes (K1) and the batch-64 train step's eight
    (K1, K2); the two kernel-table rows."""
    w1, w2 = bf16_chain_parity(cfg, card)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "f32_ms", "flops", "bytes")
    k1 = {"convert": dict.fromkeys(keys, 0.0), "train": dict.fromkeys(keys, 0.0)}
    k2 = dict.fromkeys(keys, 0.0)
    k2_parts: dict = {}
    w1_flops = 0.0
    for i, (t, c) in enumerate(stage_shapes(UTT, cfg)):
        d, v = k1_bf16_stage(cfg, card, B, t, c, 1700 + i, "convert")
        w1 = max(w1, d)
        for k in keys:
            k1["convert"][k] += v[k]
    for bsz in (2 * B64, B64):
        for i, (t, c) in enumerate(stage_shapes(SEG, cfg)):
            d, v = k1_bf16_stage(cfg, card, bsz, t, c, 1750 + i, "train b64")
            w1 = max(w1, d)
            for k in keys:
                k1["train"][k] += v[k]
            d, v = k2_bf16_stage(cfg, card, bsz, t, c, 1800 + i)
            w1_flops += v["w1_flops"]
            w2 = max(w2, d)
            for k in keys:
                k2[k] += v[k]
            add_breakdown(k2_parts, v["parts"])
    lib = cc_mod._library()["bwd_bf16"]
    ws = lib.cond_chain_bwd_bf16_workspace(*K2B_WS_SHAPE)
    wb, wt, _, wn, wcc, _ = K2B_WIDE_WS_SHAPE
    wide_ws = lib.cond_chain_bwd_bf16_workspace(*K2B_WIDE_WS_SHAPE)
    a_scratch = wb * wt * -(-wn * wcc // 8) * 8 * 2
    say(f"k2-bf16 kernels per batch-64 train step (8 calls): {breakdown_line(k2_parts, 8)}; "
        f"workspace at (B, T, E, n, Cc, 2C) = {K2B_WS_SHAPE}: {ws / 1e9:.3f} GB, at "
        f"{K2B_WIDE_WS_SHAPE} {wide_ws / 1e9:.3f} GB (of which the scratch of a "
        f"{a_scratch / 1e6:.1f} MB) [{card}]")
    w1_ms = k2_parts["k2b_w1_kernel"][0]
    w1_bound = w1_flops / PEAK_BF16_FLOPS * 1e3
    say(f"k2b_w1_kernel per batch-64 train step: {w1_ms:.3f} ms against its own bound of "
        f"{w1_bound:.3f} ms (dW1's {w1_flops / 1e12:.3f} TFLOP at "
        f"{PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s; {w1_bound / w1_ms:.1%} of it) [{card}]")
    for label, sums, per in (("k1-bf16", k1["convert"], "bf16 convert call (4 calls)"),
                             ("k1-bf16", k1["train"], "batch-64 train step (8 calls)"),
                             ("k2-bf16", k2, "batch-64 train step (8 calls)")):
        bound, by = bf16_bounds(sums["flops"], sums["bytes"])
        say(f"{label} per {per}: {sums['ms']:.3f} ms against a bound of {sums['bound_ms']:.3f} "
            f"ms ({by}; {sums['bound_ms'] / sums['ms']:.1%} of it; bf16 tensor cores "
            f"{sums['flops'] / PEAK_BF16_FLOPS * 1e3:.3f} ms, HBM "
            f"{sums['bytes'] / PEAK_BYTES * 1e3:.3f} ms); plain bf16 {sums['plain_ms']:.3f} ms, "
            f"f32 kernel {sums['f32_ms']:.3f} ms, cuDNN bf16 {sums['library_ms']:.3f} ms [{card}]")
    row1 = bf16_row("cond_chain_fwd_bf16", "td_vc_gan_tpu_torch/csrc/cond_chain_bf16.cu",
                    "td_vc_gan_tpu/ops/pallas/cond_chain.py:157", k1["convert"], w1)
    row1["by_path"] = {k: {kk: v[kk] for kk in keys[:5]} for k, v in k1.items()}
    row2 = bf16_row("cond_chain_bwd_bf16", "td_vc_gan_tpu_torch/csrc/cond_chain_bwd_bf16.cu",
                    "td_vc_gan_tpu/ops/pallas/cond_chain.py:221", k2, w2)
    return row1, row2


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    return float(10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                               / max(np.sum((got - ref).astype(np.float64) ** 2), 1e-30)))


def phase_bf16_convert(cfg, card, encoders=("conv", "wavlm"), label="bf16 convert") -> int:
    """Phase 15: bf16 conversion of phase 4's batch with each encoder: K1-bf16
    launches (one a decoder stage and one a bottleneck block, no f32 K1),
    output checks, the plain-bf16-chain path, the f32 conversion with the
    same weights and draws, RTF, pitch, peak memory. Returns the K1-bf16
    launches of every encoder's calls."""
    total = 0
    sigs = signals(0)
    labels = np.arange(B) % 100
    for enc in encoders:
        bcfg = bf16_cfg(cfg, enc)
        t0 = time.perf_counter()
        g = generator_from_config(bcfg.model.generator, num_classes=100, seed=0,
                                  compute_dtype="bfloat16")
        conv = Converter(bcfg, g, crepe_from_seed(1), decoder="viterbi")
        build_s = time.perf_counter() - t0
        # the main path: counts from 0, read right after
        cc_mod.launches = cc_mod.launches_bf16 = 0
        f0, mu = conv.pitch_batch(sigs)
        mu_tgt = mu + np.float32(np.log(1.2))
        wav = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=0)
        k1_bf16, k1_f32 = cc_mod.launches_bf16, cc_mod.launches
        total += k1_bf16
        gcfg = bcfg.model.generator
        expected = len(gcfg.decoder_ratios) + gcfg.num_bottleneck_layers
        if (k1_bf16, k1_f32) != (expected, 0):
            raise AssertionError(f"{label} ({enc}): {k1_bf16} K1-bf16 and {k1_f32} K1 "
                                 f"launches, expected {expected} and 0")
        args = [conv._tensor(a) for a in (sigs, f0, mu, mu_tgt)]
        lab = conv._tensor(labels, torch.int64)
        out_dtype = conv.convert_tensors(*args, lab, seed=0).dtype
        if (wav.shape != (B, UTT) or out_dtype != torch.float32 or not np.isfinite(wav).all()
                or np.abs(wav).max() > 1.0):
            raise AssertionError(f"bad {label} ({enc}): shape {wav.shape}, dtype "
                                 f"{out_dtype}, finite {np.isfinite(wav).all()}, max|y| "
                                 f"{np.abs(wav).max()}")
        kernel_op = cc_mod.cond_chain
        cc_mod.cond_chain = cc_mod.cond_chain_plain
        try:
            wav_plain = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=0)
        finally:
            cc_mod.cond_chain = kernel_op
        d_plain = float(np.abs(wav - wav_plain).max())
        rel_plain = d_plain / max(float(np.abs(wav_plain).max()), 1e-30)
        if not rel_plain <= BF16_AUDIO_RTOL:
            raise AssertionError(f"{label} ({enc}): the kernel path and the plain-bf16 "
                                 f"path differ by {d_plain:.3e}, {rel_plain:.2e} of max|plain|")
        g32 = generator_from_config(cfg.model.generator if enc == "conv" else
                                    wavlm_cfg(cfg).model.generator, num_classes=100, seed=0)
        wav32 = Converter(cfg, g32, crepe_from_seed(1), decoder="viterbi").convert_batch(
            sigs, labels, f0, mu, mu_tgt, seed=0)
        del g32
        d32 = float(np.abs(wav - wav32).max())
        snr = snr_db(wav32, wav)
        if not snr >= BF16_SNR_DB:
            raise AssertionError(f"{label} ({enc}) against f32: SNR {snr:.1f} dB")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: conv.convert_tensors(*args, lab, seed=1), iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        pitch_ms = cuda_ms(lambda: conv.pitch_tensors(args[0]), iters=2, warmup=1)
        audio_s = B * UTT / bcfg.model.sample_rate
        say(f"{label} ({enc}): G built in {build_s:.1f} s; K1-bf16 launches {k1_bf16}, K1 "
            f"(f32) {k1_f32}; output f32, finite, max|y| {np.abs(wav).max():.4f}; kernel path vs "
            f"plain-bf16-chain path max|d| {d_plain:.3e} ({rel_plain:.2e} of max|plain|, "
            f"tolerance {BF16_AUDIO_RTOL:.0e}); against "
            f"the f32 conversion (same weights and draws) max|d| {d32:.3e} "
            f"({d32 / float(np.abs(wav32).max()):.2e} of max|ref|), SNR {snr:.1f} dB (at least "
            f"{BF16_SNR_DB:.0f}); convert_tensors {ms:.2f} ms per call: RTF "
            f"{audio_s / (ms / 1e3):.1f}x; pitch_tensors (Viterbi, f32) {pitch_ms:.2f} ms; peak "
            f"device memory {peak:.2f} GiB [{card}]")
        profile_call(lambda: conv.convert_tensors(*args, lab, seed=1),
                     f"one {label} ({enc}) call", card, top=6)
        del conv, g, args
        gc.collect()
        torch.cuda.empty_cache()
    return total


def train_batch64(seed: int) -> dict:
    """64 x 8960 training segments, as ``train_batch``."""
    sig = np.concatenate([signals(seed + 7 * k, SEG) for k in range(B64 // B)])
    noise = np.random.default_rng(seed + 1).standard_normal(sig.shape).astype(np.float32)
    return {"signal": torch.from_numpy(sig).cuda(),
            "corrupted": torch.from_numpy(sig + 0.05 * noise).cuda(),
            "label": torch.arange(B64, device="cuda") % NUM_SPK}


def phase_bf16_train(cfg, card) -> tuple[int, int]:
    """Phase 16: the bf16 train step at batch 64 x 8960 with each encoder
    (wavlm-stage2_2 first, the JAX package's headline): its first step
    against the plain-bf16-chain step, then timed steps with the launch
    counts of each, parameter, moment and loss checks, peak memory and a
    profile. Returns the K1-bf16 and K2-bf16 launches of the timed steps."""
    k1_total = k2_total = 0
    batch = train_batch64(10)
    for enc in ("wavlm", "conv"):
        bcfg = bf16_cfg(cfg, enc)
        t0 = time.perf_counter()
        state = train_state(bcfg)
        step = build_train_step(bcfg, state)
        trainable = {f"G.{k}": p.detach().clone() for k, p in state.G.named_parameters()
                     if p.requires_grad}
        trainable.update({f"D.{k}": p.detach().clone() for k, p in state.D.named_parameters()})
        setup_s = time.perf_counter() - t0
        m_kernel = step(batch, torch.Generator(device="cuda").manual_seed(5))
        twin = train_state(bcfg)
        twin_step = build_train_step(bcfg, twin)
        kernel_op = cc_mod.cond_chain
        cc_mod.cond_chain = cc_mod.cond_chain_plain
        try:
            m_plain = twin_step(batch, torch.Generator(device="cuda").manual_seed(5))
        finally:
            cc_mod.cond_chain = kernel_op
        worst_loss = max(abs(float(m_kernel[k]) - float(m_plain[k])) /
                         max(abs(float(m_plain[k])), 1e-6) for k in m_plain)
        if not worst_loss <= BF16_STEP_LOSS_RTOL:
            raise AssertionError(f"bf16 {enc} step: the kernel path's first losses differ from "
                                 f"the plain-bf16-chain step's by {worst_loss:.2e}")
        del twin, twin_step
        gc.collect()
        torch.cuda.empty_cache()

        gen = torch.Generator(device="cuda").manual_seed(6)
        step(batch, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts = [], []
        cc_mod.launches = cc_mod.bwd_launches = 0
        cc_mod.launches_bf16 = cc_mod.bwd_launches_bf16 = 0
        for _ in range(TRAIN_STEPS):
            before = (cc_mod.launches_bf16, cc_mod.bwd_launches_bf16, cc_mod.launches,
                      cc_mod.bwd_launches)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            metrics = step(batch, gen)
            end.record()
            counts.append(tuple(a - b for a, b in zip(
                (cc_mod.launches_bf16, cc_mod.bwd_launches_bf16, cc_mod.launches,
                 cc_mod.bwd_launches), before)))
            times.append((start, end))
        torch.cuda.synchronize()
        k1_total += cc_mod.launches_bf16
        k2_total += cc_mod.bwd_launches_bf16
        ms = sorted(s.elapsed_time(e) for s, e in times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite losses in the bf16 {enc} step: {bad}")
        if any(c != (STAGES * 2, STAGES * 2, 0, 0) for c in counts):
            raise AssertionError(f"bf16 {enc} step: (K1-bf16, K2-bf16, K1, K2) launches per "
                                 f"step {counts}, expected ({STAGES * 2}, {STAGES * 2}, 0, 0)")
        params = dict(state.G.named_parameters(prefix="G"))
        params.update(state.D.named_parameters(prefix="D"))
        still = [k for k, v in trainable.items() if torch.equal(v, params[k])]
        not_f32 = [k for k, p in params.items() if p.dtype != torch.float32]
        for opt in (state.opt_g, state.opt_d):
            for p in opt.params:
                for key, v in opt.optimizer.state[p].items():
                    if torch.is_tensor(v) and v.dim() and v.dtype != torch.float32:
                        not_f32.append(f"moment {key} {tuple(v.shape)}")
        if still or not_f32:
            raise AssertionError(f"bf16 {enc} step: parameters that did not change "
                                 f"{still[:5]}; tensors not f32 {not_f32[:5]}")
        median = ms[len(ms) // 2]
        say(f"bf16 train ({enc}): batch {B64} x {SEG}, set up in {setup_s:.1f} s; first step "
            f"against the plain-bf16-chain step: losses worst relative difference "
            f"{worst_loss:.2e} (tolerance {BF16_STEP_LOSS_RTOL:.0e}); {TRAIN_STEPS} timed "
            f"steps: median {median:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{B64 * 1e3 / median:.2f} segments/s; K1-bf16/K2-bf16/K1/K2 per step {counts[0]}; "
            f"G_loss {float(metrics['G_loss']):.4f}; every trainable parameter changed, "
            f"parameters and AdamW moments f32; peak device memory {peak:.2f} GiB [{card}]")
        profile_call(lambda: step(batch, gen), f"one bf16 {enc} train step (batch {B64})",
                     card, top=12)
        del state, step, trainable, params
        gc.collect()
        torch.cuda.empty_cache()
    return k1_total, k2_total


def phase_bf16_clis(root: Path, card: str) -> tuple[int, int, int]:
    """Phase 17: the train CLI with ``--override train.compute_dtype=bfloat16``
    (conv encoder) on phase 9's corpus, epoch 0 with a save, then a resume
    without the override, which takes bf16 from the train state; then the
    conversion CLI on that run. Returns (train K1-bf16, train K2-bf16,
    conversion K1-bf16)."""
    run = root / "bf16_run"
    base = ["--save_path", str(run), "--data_path", str(root)]
    for o in CLI_OVERRIDES:
        base += ["--override", o]
    first, wall1 = run_cli("td_vc_gan_tpu_torch.cli.train",
                           base + ["--override", "train.compute_dtype=bfloat16"])
    second, wall2 = run_cli("td_vc_gan_tpu_torch.cli.train", base + [
        "--load_path", str(run), "--max_steps", "7", "--override", "train.num_epoch=1"])
    restored = one_line(second, "train.compute_dtype bfloat16 from the train state")[0]
    resumed_cfg = load_config(run / "config.yaml")
    if resumed_cfg.train.compute_dtype != "bfloat16":
        raise AssertionError(f"the resumed run's config says {resumed_cfg.train.compute_dtype}")
    steps, resumed = step_lines(first), step_lines(second)
    if [s["Itt"] for s in steps] != list(range(5)) or [s["Itt"] for s in resumed] != [5, 6]:
        raise AssertionError(f"bf16 CLI: logged steps {[s['Itt'] for s in steps]} then "
                             f"{[s['Itt'] for s in resumed]}")
    bad = [(s["Itt"], k) for s in steps + resumed for k, v in s.items() if not np.isfinite(v)]
    counts = {(int(s["k1"]), int(s["k2"])) for s in steps + resumed}
    if bad or counts != {(STAGES * 2, STAGES * 2)}:
        raise AssertionError(f"bf16 CLI: non-finite values {bad[:5]}, K1/K2 per step "
                             f"{sorted(counts)}")
    done = [re.search(r"K1 (\d+) \(validation (\d+), samples (\d+)\), K2 (\d+) \(bf16 "
                      r"instances: K1 (\d+), K2 (\d+)\)", one_line(lines, "Done at step")[0])
            .groups() for lines in (first, second)]
    n_steps = (len(steps), len(resumed))
    for (k1, val, samples, k2, k1b, k2b), n in zip(done, n_steps):
        # train steps and validation run in bf16; the sample dumps in f32
        if (int(k2b), int(k2)) != (STAGES * 2 * n, STAGES * 2 * n) or \
                int(k1b) != STAGES * 2 * n + int(val) or int(k1) != int(k1b) + int(samples):
            raise AssertionError(f"bf16 CLI launches: {done}")
    gen_lines, gen_wall = run_cli("td_vc_gan_tpu_torch.cli.generate_with_target",
                                  ["--save_path", str(root / "bf16_converted"),
                                   "--load_path", str(run), "--data_path", str(root)])
    calls, _, _, rtf, gen_k1, peak_y = convert_summary(gen_lines, "bfloat16")
    loop_ms = sorted(s["step_ms"] for s in steps if s["Itt"] >= 1)
    say(f"bf16 cli: train CLI --override train.compute_dtype=bfloat16: {len(steps)} steps "
        f"(epoch 0) in {wall1:.1f} s of wall time, loop step median of steps 1-4 "
        f"{(loop_ms[1] + loop_ms[2]) / 2:.2f} ms; a resume without the override for "
        f"{len(resumed)} steps in {wall2:.1f} s ({restored.split(' (')[0]}; its config.yaml "
        f"bfloat16); every logged loss finite; K1/K2 {STAGES * 2}/{STAGES * 2} per step, bf16 "
        f"instances (train steps and validation) {[(int(d[4]), int(d[5])) for d in done]}, "
        f"the sample dumps in f32 as in the JAX loop; conversion CLI: {calls} convert_batch "
        f"calls, K1-bf16 {gen_k1}, outputs finite, max|y| {float(peak_y):.4f}, RTF "
        f"{float(rtf):.1f}x inside the CLI, {gen_wall:.1f} s of wall time [{card}]")
    return (sum(int(d[4]) for d in done), sum(int(d[5]) for d in done), int(gen_k1))


# ---------------------------------------------------------------------------
# the curriculum's first stages: phases 18-19
# ---------------------------------------------------------------------------


# The stage settings, as the train CLI's --override lines. S1,
# conv_enc-stage1: the JAX suite's stage-1 weights (tests/test_train_step.py:
# 87-88) with the converted contrastive term on; with lambda_rec 0 it encodes
# the fake batch itself. S21, stage 2-1: the defaults with lambda_rec 0 and
# the latent classifier on. W1, wavlm-stage1's settings: no_conv (the target
# is the source), with the pitch and contrastive losses kept on and jitter.
STAGE_S1 = ("train.no_conv=false", "train.lambda_rec=0", "train.lambda_idt=5",
            "train.lambda_f0=10", "train.lambda_cont_emb=1", "train.lambda_latcls=1",
            "train.lambda_converted=0.5")
STAGE_S21 = ("train.lambda_rec=0", "train.lambda_latcls=1")
STAGE_W1 = ("model.generator.encoder_model=wavlm", "train.no_conv=true", "train.lambda_rec=0",
            "train.lambda_idt=20", "train.lambda_f0=10", "train.lambda_cont_emb=1",
            "train.jitter_amp=40")


def stage_cfg(overrides) -> Config:
    return load_config(None, parse_overrides(["model.generator.encoder_model=conv",
                                              *overrides]))


def write_raw_corpus(root: Path) -> Path:
    """Phase 9's utterances (the same draws) as a tree of speaker folders,
    all 16-bit WAV, for prepare_dataset."""
    rng = np.random.default_rng(20)
    for spk in range(CORPUS_SPK):
        folder = root / f"s{spk:02d}"
        folder.mkdir(parents=True)
        for j in range(CORPUS_UTT):
            write_audio(folder / f"s{spk:02d}_{j:03d}.wav",
                        utterance(rng, int(rng.uniform(1.5, 4.0) * 16000)), 16000)
    return root


def curriculum_train(args: list[str], label: str, itts: list[int],
                     with_c: bool) -> tuple[list[str], float]:
    """A train CLI run of the curriculum: its logged steps are ``itts``,
    every logged value finite, K1/K2 STAGES each per step, the latent
    classifier's losses logged when ``with_c``."""
    lines, wall = run_cli("td_vc_gan_tpu_torch.cli.train", args)
    steps = step_lines(lines)
    bad = [(s["Itt"], k) for s in steps for k, v in s.items() if not np.isfinite(v)]
    counts = {(int(s["k1"]), int(s["k2"])) for s in steps}
    has_c = {"C_loss" in s and "C_acc" in s for s in steps}
    if [s["Itt"] for s in steps] != itts or bad or counts != {(STAGES, STAGES)} or \
            has_c != {with_c} or not all(s["G_loss_lat_cls"] > 0 for s in steps if with_c):
        raise AssertionError(f"{label}: steps {[s['Itt'] for s in steps]} (expected {itts}), "
                             f"non-finite {bad[:5]}, K1/K2 per step {sorted(counts)}, C "
                             f"logged {has_c}")
    return lines, wall


def phase_curriculum_clis(root: Path, card: str) -> tuple[int, int, int]:
    """Phase 19: the dataset CLIs on raw speaker folders, stage 1 (S1 without
    the latent classifier) for two epochs, the hand-off to stage 2-1 from
    stage 1's epoch 0 (C from the seed), then every conversion and
    inspection CLI on the result. Returns (train K1, train K2, convert K1)."""
    t_phase = time.perf_counter()
    walls = {}
    # the nine dataset, conversion and inspection CLIs run in one process,
    # which imports torch once; the two train runs are processes of their
    # own, as the hand-off between them is a resume across processes
    clis = CliProcess()

    def cli(name, args, variant=""):
        lines, walls[name + variant] = clis.run(f"td_vc_gan_tpu_torch.cli.{name}", args)
        return lines

    raw, data, sub = root / "raw", root / "curriculum", root / "curriculum_sub"
    write_raw_corpus(raw)
    cli("prepare_dataset", [str(raw), "--save_folder", str(data), "--ext", ".wav",
                            "--test_size", "1"])
    train = (data / "train_files").read_text().split()
    test = (data / "test_files").read_text().split()
    with open(data / "speakers", "rb") as f:
        speakers = pickle.load(f)
    # 6 utterances a speaker, 6 > 5 * 1: its first (sorted) to test, 5 to train
    if (len(speakers), len(train), len(test)) != (CORPUS_SPK, CORPUS_SPK * 5, CORPUS_SPK) or \
            any(not ln.split("|")[0].endswith("_000.wav") for ln in test):
        raise AssertionError(f"prepare_dataset: {len(speakers)} speakers, {len(train)} train "
                             f"and {len(test)} test files")
    cli("preprocess_dataset", [str(raw), "--normalization_db", "-30"])
    levels = [20 * np.log10(np.sqrt(np.mean(read_audio(ln.split("|")[0])[0].astype(np.float64)
                                            ** 2))) for ln in train[::16]]
    if max(abs(v + 30) for v in levels) > 0.05:
        raise AssertionError(f"preprocess_dataset: RMS levels {levels} dB, expected -30")
    cli("subset_dataset", [str(data), str(sub), "--num_speakers", "4",
                           "--utts_per_speaker", "1", "--seed", "3"])
    sub_test = (sub / "test_files").read_text().split()
    if len(sub_test) != 4 or len({ln.split("|")[1] for ln in sub_test}) != 4:
        raise AssertionError(f"subset_dataset: {sub_test}")
    paths = [ln.split("|")[0] for ln in sub_test]
    (sub / "pairs").write_text("".join(f"pair{k}|{paths[k]}|{paths[(k + 1) % 4]}\n"
                                       for k in range(4)))
    pre = cli("precorrupt_dataset", [str(data / "train_files"), "--save_folder",
                                     str(root / "precorrupted"), "--variants", "2",
                                     "--normalization_db", "-30"])
    with open(root / "precorrupted" / "precorrupt_index.pkl", "rb") as f:
        index = pickle.load(f)
    if sorted(index) != sorted(ln.split("|")[0] for ln in train) or \
            any(len(v) != 2 or not all(Path(p).exists() for p in v) for v in index.values()):
        raise AssertionError("precorrupt_dataset: the index does not cover the manifest")

    # stage 1, S1 without the latent classifier, two epochs with a save each
    stage1, stage21 = root / "stage1", root / "stage2_1"
    base = ["--data_path", str(data)]
    for o in CLI_OVERRIDES + ("log.gen_interval=100",):
        base += ["--override", o]
    s1 = [o.replace("lambda_latcls=1", "lambda_latcls=0") for o in STAGE_S1]
    first, walls["train (stage 1)"] = curriculum_train(
        base + ["--save_path", str(stage1), "--override", "train.num_epoch=1"]
        + [a for o in s1 for a in ("--override", o)], "stage 1", list(range(10)), False)
    if (stage1 / "step0-C.pt").exists() or not (stage1 / "step1-G.pt").exists():
        raise AssertionError("stage 1 saved a latent classifier, or no epoch 1")
    # stage 2-1 from stage 1's epoch 0, with the stored corruption variants
    second, walls["train (stage 2-1)"] = curriculum_train(
        base + ["--save_path", str(stage21), "--load_path", str(stage1), "--epoch", "0",
                "--precorrupted_index", str(root / "precorrupted" / "precorrupt_index.pkl"),
                "--override", "train.num_epoch=1"]
        + [a for o in STAGE_S21 for a in ("--override", o)], "stage 2-1", list(range(5, 10)),
        True)
    handoff = one_line(second, "Resumed train state epoch 0")[0]
    if "(step 5," not in handoff or "restored G+D, C from the seed)" not in handoff:
        raise AssertionError(f"the hand-off: {handoff}")
    for name in ("step1-G.pt", "step1-D.pt", "step1-C.pt"):
        if not (stage21 / name).exists():
            raise AssertionError(f"stage 2-1 saved no {name}")
    done = [re.search(r"K1 (\d+) \(validation (\d+), samples (\d+)\), K2 (\d+)",
                      one_line(lines, "Done at step")[0]).groups() for lines in (first, second)]

    # conversion and inspection on stage 2-1's run
    load = ["--load_path", str(stage21), "--data_path", str(sub)]
    out = {name: root / f"curriculum_{name}" for name in
           ("target", "list", "dataset", "source_pitch")}
    gen = {"generate_with_target": convert_summary(cli(
        "generate_with_target", load + ["--save_path", str(out["target"])]))}
    gen["generate_from_list"] = convert_summary(cli(
        "generate_from_list", load + ["--save_path", str(out["list"])]))
    gen["generate_from_dataset"] = convert_summary(cli(
        "generate_from_dataset", load + ["--save_path", str(out["dataset"])]))
    gen["generate_from_dataset --use_source_pitch"] = convert_summary(cli(
        "generate_from_dataset", load + ["--save_path", str(out["source_pitch"]),
                                         "--use_source_pitch"], " --use_source_pitch"))
    spk = [ln.split("|")[1] for ln in sub_test]
    ids = [speakers[s] for s in spk]  # in the manifest's order
    want = {
        "target": {f"000-{a}-{b}-conv.wav" for a in spk for b in spk}
        | {f"000-{a}-X-orig.wav" for a in spk} | {"conv_log.txt"},
        "list": {f"pair{k}.wav" for k in range(4)},
        "dataset": {f"sig{i:02d}_{ids[i]}-{t}_conv.wav" for i in range(4) for t in ids}
        | {f"sig{i:02d}_{ids[i]}-X_orig.wav" for i in range(4)},
    }
    want["source_pitch"] = want["dataset"]
    for name, files in want.items():
        got = {p.name for p in out[name].iterdir()}
        if got != files:
            raise AssertionError(f"{name}: files {sorted(got ^ files)[:6]} differ")
    calls = {k: v.calls for k, v in gen.items()}
    if calls != {"generate_with_target": 4, "generate_from_list": 4,
                 "generate_from_dataset": 16, "generate_from_dataset --use_source_pitch": 16}:
        raise AssertionError(f"convert calls {calls}")
    f0 = cli("sample_f0", [str(out["target"]), "--out", str(root / "f0.png")])
    ratios = json.loads((out["target"] / "f0_ratios.json").read_text())
    if not ratios or not all(np.isfinite(r["f0_ratio"]) and r["f0_ratio"] > 0
                             for r in ratios.values()):
        raise AssertionError(f"sample_f0: {len(ratios)} pairs, {list(ratios.values())[:2]}")
    plot = "plot written" if (root / "f0.png").exists() else one_line(f0, "matplotlib")[0]
    info = cli("get_model_info", [str(stage1)])
    clis.close()
    facts = dict(ln.split(": ", 1) for ln in info if ": " in ln)
    if facts.get("checkpoints") != "4" or facts.get("epoch_range") != "(0, 1)":
        raise AssertionError(f"get_model_info: {info}")

    train_k1 = sum(int(d[0]) for d in done)
    train_k2 = sum(int(d[3]) for d in done)
    gen_k1 = sum(v.k1 for v in gen.values())
    s1_ms = sorted(s["step_ms"] for s in step_lines(first) if s["Itt"] >= 1)
    s21_ms = sorted(s["step_ms"] for s in step_lines(second) if s["Itt"] >= 6)
    pre_s = pre[-1].split(" in ")[1].split(" with")[0]
    say(f"curriculum cli: prepare_dataset {CORPUS_SPK} speakers, {len(train)} train and "
        f"{len(test)} test files; preprocess_dataset to -30 dB (RMS {min(levels):.3f} to "
        f"{max(levels):.3f} dB); subset_dataset 4 x 1; precorrupt_dataset {len(index)} "
        f"utterances x 2 variants ({pre_s} inside the CLI)")
    say(f"curriculum cli: stage 1 (S1, no C) steps 0-9 and stage 2-1 (S21) steps 5-9 from "
        f"stage 1's epoch 0 ({handoff.split('; ')[-1][:-1]}), with the stored variants: every "
        f"logged loss finite, K1/K2 {STAGES}/{STAGES} in every step, C_loss, C_acc and "
        f"G_loss_lat_cls in stage 2-1; loop step ms, median of steps 1-9 "
        f"{s1_ms[len(s1_ms) // 2]:.2f} (stage 1) and of steps 6-9 "
        f"{s21_ms[len(s21_ms) // 2]:.2f} (stage 2-1); K1 launches (all, of them "
        f"validation, sample dumps) {[(int(d[0]), int(d[1]), int(d[2])) for d in done]}, K2 "
        f"{[int(d[3]) for d in done]}")
    say("curriculum cli: " + "; ".join(
        f"{k} {v.calls} calls, K1 {v.k1}, max|y| {v.peak:.4f}, RTF {v.rtf:.1f}x "
        f"inside the CLI" for k, v in gen.items())
        + f"; every output finite, its files named as the JAX CLI's; sample_f0 "
        f"{len(ratios)} pairs, ratios {min(r['f0_ratio'] for r in ratios.values()):.3f} to "
        f"{max(r['f0_ratio'] for r in ratios.values()):.3f} ({plot}); get_model_info "
        f"{facts['checkpoints']} checkpoints, epochs {facts['epoch_range']}")
    say("curriculum cli: wall time per CLI (train: its own process; the others: main() "
        "in one process): " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; phase 19 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return train_k1, train_k2, gen_k1


# ---------------------------------------------------------------------------
# the evaluation harness: phase 20
# ---------------------------------------------------------------------------


# The evaluation models on the card against the CPU, f32 with TF32 off: of
# max|ref| (ECAPA's embeddings, MOSNet's frame scores).
EVAL_RTOL = 1e-4
EVAL_SEED = 13


def phase_eval(root: Path, card: str) -> int:
    """Phase 20: ECAPA-TDNN and MOSNet at their published widths from seeded
    checkpoints on phase 19's 16 test utterances, card against CPU; the
    WORLD analysis and the DTW's host time; then ``run_test`` as a process
    on phase 19's stage-2-1 run (its 4 test utterances to 4 speakers), every
    stage with the models above. Returns run_test's K1 launches."""
    t_phase = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("transformers", "h5py", "matplotlib")}
    say("eval: optional packages importable on this machine: "
        + ", ".join(f"{m} {importlib.metadata.version(m) if v else 'no'}"
                    for m, v in have.items()))
    ev = root / "eval"
    ev.mkdir()
    utts = [read_audio(ln.split("|")[0], 16000)[0].astype(np.float32) for ln in
            (root / "curriculum" / "test_files").read_text().split()]

    with IN_PROCESS_GPU:  # phase 21's kernel work waits: the peaks are these models'
        ecapa_ckpt = ev / "embedding_model.ckpt"
        torch.save({k: torch.from_numpy(v) for k, v in ecapa.init_ecapa_params(EVAL_SEED).items()},
                   ecapa_ckpt)
        on = {dev: ecapa.EcapaEmbedder.from_speechbrain(str(ecapa_ckpt), device=dev)
              for dev in ("cpu", "cuda")}
        n_ecapa = sum(t.numel() for t in on["cuda"].model.state_dict().values())
        on["cuda"].embed(utts[0])  # cuDNN's first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = [on["cuda"].embed(w) for w in utts]
        ecapa_ms = (time.perf_counter() - t0) * 1e3 / len(utts)
        ecapa_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = [on["cpu"].embed(w) for w in utts]
        ecapa_err = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
        if not all(np.isfinite(g).all() and g.shape == (ecapa.LIN_NEURONS,) for g in got) or \
                ecapa_err > EVAL_RTOL:
            raise AssertionError(f"ECAPA: card against CPU {ecapa_err:.3e} of max|ref| "
                                 f"(tolerance {EVAL_RTOL})")
        del on
        parts = {"ECAPA (card and CPU)": time.perf_counter() - t_phase}
        say(f"eval ecapa: published width (channels {ecapa.CHANNELS}, scale {ecapa.RES2NET_SCALE}, "
            f"{ecapa.LIN_NEURONS}-d; {n_ecapa:,} tensor elements with BN statistics) from a seeded "
            f"speechbrain-layout embedding_model.ckpt; {len(utts)} utterances "
            f"({min(map(len, utts)) / 16000:.2f}-{max(map(len, utts)) / 16000:.2f} s), card "
            f"against CPU {ecapa_err:.3e} of max|ref| (tolerance {EVAL_RTOL}); {ecapa_ms:.2f} ms "
            f"per utterance on the card (one utterance per call, fbank on the host included), "
            f"peak {ecapa_peak:.2f} GiB [{card}]")

        slots = mosnet.init_mosnet_params(EVAL_SEED)
        rng = np.random.default_rng(EVAL_SEED)
        for k in slots:
            if k.endswith(".bias"):
                slots[k] = (0.1 * rng.standard_normal(slots[k].shape)).astype(np.float32)
        mos_ckpt = ev / "mosnet.npz"
        np.savez(mos_ckpt, **slots)
        pred = {dev: mosnet.MOSPredictor(mosnet.load_mosnet(str(mos_ckpt)), dev)
                for dev in ("cpu", "cuda")}
        mags = [torch.from_numpy(mosnet.spectrogram(w)[None]) for w in utts]
        with torch.no_grad():
            pred["cuda"].model(mags[0].cuda())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = [pred["cuda"].model(m.cuda())[1].cpu().numpy() for m in mags]
            mos_ms = (time.perf_counter() - t0) * 1e3 / len(utts)
            want = [pred["cpu"].model(m)[1].numpy() for m in mags]
        mos_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mos_err = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
        if not all(np.isfinite(g).all() for g in got) or mos_err > EVAL_RTOL:
            raise AssertionError(f"MOSNet: card against CPU {mos_err:.3e} of max|ref| "
                                 f"(tolerance {EVAL_RTOL})")
        n_slots = sum(v.size for v in slots.values())
        scores = [pred["cuda"].score(w) for w in utts[:2]]
        del pred
        parts["MOSNet (card and CPU)"] = time.perf_counter() - t_phase - sum(parts.values())
        say(f"eval mosnet: published width ({n_slots:,} parameters in the Keras slots; torch's "
            f"LSTM adds {2 * 4 * mosnet.LSTM_UNITS:,} zero b_hh) from a seeded .npz; frame scores "
            f"of {len(utts)} utterances, card against CPU {mos_err:.3e} of max|ref| (tolerance "
            f"{EVAL_RTOL}); {mos_ms:.2f} ms per utterance on the card (model only), peak "
            f"{mos_peak:.2f} GiB; MOS of the first two {scores[0]:.4f}, {scores[1]:.4f} [{card}]")

    t0 = time.perf_counter()
    mceps = [mcd.world_mcep(w) for w in utts]
    world_s = (time.perf_counter() - t0) / len(utts)
    t0 = time.perf_counter()
    pairs = [mcd.mcd_from_mceps(mceps[i][0], mceps[(i + 1) % len(utts)][0])
             for i in range(len(utts))]
    dtw_s = (time.perf_counter() - t0) / len(utts)
    if not all(np.isfinite(pairs)):
        raise AssertionError(f"MCD between the test utterances: {pairs}")
    cells = [len(mceps[i][0]) * len(mceps[(i + 1) % len(utts)][0]) for i in range(len(utts))]
    parts["WORLD and the DTW"] = time.perf_counter() - t_phase - sum(parts.values())
    say(f"eval host: WORLD analysis (dio, stonemask, cheaptrick, sp2mc) {world_s:.3f} s per "
        f"utterance, {2 * world_s:.3f} s per utterance pair; the exact DTW with its distance "
        f"matrix {dtw_s:.3f} s per pair ({min(cells):,}-{max(cells):,} cells); MCD between "
        f"neighbouring test utterances {min(pairs):.3f}-{max(pairs):.3f}")

    stages = "mcd,spkrec,mosnet,info,html"
    args = ["--save_path", str(ev / "run_test"), "--load_path", str(root / "stage2_1"),
            "--data_path", str(root / "curriculum_sub"), "--ecapa_checkpoint", str(ecapa_ckpt),
            "--mosnet_ckpt", str(mos_ckpt)]
    if have["transformers"]:
        stages += ",asr"
        args += ["--asr_model", testing.tiny_whisper_checkpoint(ev / "whisper")]
    parts["the tiny Whisper written"] = time.perf_counter() - t_phase - sum(parts.values())
    lines, wall = run_cli("td_vc_gan_tpu_torch.cli.run_test", args + ["--stages", stages])
    parts["run_test"] = wall
    conv = convert_summary(lines)
    out = ev / "run_test"
    results = ["mcd_results", "spkrec_results", "mosnet_results", "info"]
    results += ["asr_results"] if have["transformers"] else []
    missing = [r for r in results + ["index.html", "index.json"] if not (out / r).exists()]
    if missing or conv.calls != 4 or len(list((out / "signals").glob("*-conv.wav"))) != 16:
        raise AssertionError(f"run_test: missing {missing}, {conv.calls} convert calls")
    with open(out / "mcd_results", "rb") as f:
        mcds = pickle.load(f)
    with open(out / "spkrec_results", "rb") as f:
        spk = pickle.load(f)
    with open(out / "mosnet_results", "rb") as f:
        mos = pickle.load(f)
    base = [v for s_, row in mcds["mcd_result_orig"].items() for t_, vs in row.items()
            for v in vs if s_ != t_]
    conv_mcd = [v for row in mcds["mcd_result_conv"].values() for vs in row.values() for v in vs]
    sims = [v for row in spk["emb_dist"].values() for vs in row.values() for v in vs]
    mos_conv = [v for row in mos["mos_result_conv"].values() for vs in row.values() for v in vs]
    if len(base) != 12 or not all(np.isfinite(base)) or len(conv_mcd) != 16 or \
            spk["backend"] != "ecapa" or len(sims) != 16 or not all(np.isfinite(sims)) or \
            len(mos_conv) != 16 or not all(np.isfinite(mos_conv)):
        raise AssertionError(f"run_test: orig-vs-orig MCD {base}, {len(conv_mcd)} conversion "
                             f"MCDs, speaker backend {spk['backend']}, {len(sims)} "
                             f"similarities, {len(mos_conv)} MOS")
    asr_line = "the ASR stage did not run on this machine: transformers is not importable " \
        "here, so run_test ran without --asr_model, as the JAX CLI does with no model " \
        "(the stage is held by the CPU tests)"
    if have["transformers"]:
        with open(out / "asr_results", "rb") as f:
            asr = pickle.load(f)
        if not (np.isfinite(asr["asr_results_wer"]) and np.isfinite(asr["asr_results_cer"])):
            raise AssertionError(f"run_test: ASR {asr}")
        asr_line = (f"ASR on the card with a tiny Whisper written from a seed: WER "
                    f"{asr['asr_results_wer']:.3f}, CER {asr['asr_results_cer']:.3f} of the "
                    f"conversions against the originals' transcripts")
    say(f"eval run_test: stages {stages} on stage 2-1's run, 4 utterances x 4 speakers: "
        f"{conv.calls} convert calls, K1 launches {conv.k1} ({STAGES} a call), outputs "
        f"finite, max|y| {conv.peak:.4f}; orig-vs-orig MCD finite in all {len(base)} pairs "
        f"(mean {np.mean(base):.3f}); {int(np.isfinite(conv_mcd).sum())} of {len(conv_mcd)} "
        f"conversion MCDs finite (not required: a 15-step G may convert to near-noise, where "
        f"the guard of fewer than 10 voiced frames gives NaN); ECAPA similarity mean {np.mean(sims):.3f}; MOS mean "
        f"{np.mean(mos_conv):.4f}; {asr_line}; result pickles and index.html written; "
        f"{wall:.1f} s of wall time for the process")
    say(f"eval: phase 20 {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + f" (its generation {conv.conv_s:.1f} s inside the process) [{card}]")
    return conv.k1


# The A/B of ``python3 chip_smoke.py --ab DIR``: rounds of old and new,
# alternated (old, new, then new, old, ...).
# Phase 21: data parallelism. The ranks' first step against one rank's on
# the whole batch (same weights, same global draws): losses and first
# moments within phase 7's twin tolerances (the mean of the ranks' gradients
# sums in another order, and cuDNN picks its algorithms per batch size,
# which moves the leaky_relu slope where h is within rounding of 0, as the
# plain chain does); parameters within DP_PARAM_ATOL where the first
# moment's sign is settled (above STEP_MU_RTOL of the tensor's max|ref|),
# elsewhere within AdamW's first step, 2 lr. The ranks' replicas equal bit
# for bit (one all-reduce gives every rank the same sums).
DP_STEPS = 3              # steps on each rank: the first compared, the rest timed
DP_PARAM_ATOL = 1e-6
# convert_long_sharded on several devices against one device: each shard is
# a batch of another size, for which cuDNN may pick another algorithm; the
# JAX package's own tolerance for its sharded conversion
# (tests/test_inference.py).
SHARD_RTOL, SHARD_ATOL = 2e-4, 2e-5
LONG_S = 60               # seconds of the sharded conversion's utterance
DP_TIMEOUT = 600


def dp_compare(label: str, results: list[dict], ref: dict) -> tuple[float, float, float]:
    """Rank 0's first step against the one-rank step ``ref`` (metrics,
    first moments, parameters, with the tolerances above); every rank's
    replica and generator against rank 0's, bit for bit. Returns (worst
    loss, worst moment, worst settled parameter) difference."""
    r0 = results[0]
    for r, res in enumerate(results[1:], 1):
        for tag, kinds in r0["state"].items():
            for kind, tensors in kinds.items():
                diff = [n for n, v in tensors.items()
                        if not torch.equal(v, res["state"][tag][kind][n])]
                if diff:
                    raise AssertionError(f"{label}: rank {r}'s {tag} {kind} differ from rank "
                                         f"0's: {diff[:5]}")
        if not torch.equal(res["generator"], r0["generator"]):
            raise AssertionError(f"{label}: rank {r}'s generator differs from rank 0's")
    if not torch.equal(r0["generator"], ref["generator"]):
        raise AssertionError(f"{label}: the ranks' generator differs from the one-rank step's")
    m, m_ref = r0["metrics"][0], ref["metrics"]
    if set(m) != set(m_ref):
        raise AssertionError(f"{label}: other metrics than the one-rank step's")
    worst_loss = max(abs(m[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-6) for k in m_ref)
    worst_mu = worst_p = 0.0
    for tag, kinds in ref["state"].items():
        lr = ref["lr"][tag]
        for n, want in kinds["exp_avg"].items():
            got = r0["state"][tag]["exp_avg"][n]
            scale = max(float(want.abs().max()), 1e-30)
            worst_mu = max(worst_mu, float((got - want).abs().max()) / scale)
            settled = want.abs() > STEP_MU_RTOL * scale
            d = (r0["state"][tag]["params"][n] - kinds["params"][n]).abs()
            if d.numel() and float(d.max()) > 2 * lr + DP_PARAM_ATOL:
                raise AssertionError(f"{label}: {tag}.{n} moved {float(d.max()):.2e} from the "
                                     f"one-rank step's, over 2 lr")
            if settled.any():
                worst_p = max(worst_p, float(d[settled].max()))
    say(f"{label}: first step against one rank's on the {B} items: losses worst relative "
        f"difference {worst_loss:.2e} (tolerance {STEP_LOSS_RTOL:.0e}); first moments worst "
        f"max|d| {worst_mu:.2e} of the tensor's max|ref| (tolerance {STEP_MU_RTOL:.0e}); "
        f"parameters worst |d| {worst_p:.2e} where the moment's sign is settled (tolerance "
        f"{DP_PARAM_ATOL:.0e}), within 2 lr elsewhere; {len(results)} replicas and "
        f"generators bit-identical")
    if not (worst_loss <= STEP_LOSS_RTOL and worst_mu <= STEP_MU_RTOL
            and worst_p <= DP_PARAM_ATOL):
        raise AssertionError(f"{label}: the ranks' step disagrees with the one-rank step")
    return worst_loss, worst_mu, worst_p


def dp_ranks(label: str, world: int, payload: Path, out: Path, device: str, backend: str,
             ref: dict, card: str) -> tuple[int, int]:
    """The payload's steps on ``world`` ranks (``testing.step_rank``, one
    process each); checks and prints them; returns their (K1, K2) launches,
    all ranks together."""
    out.mkdir()
    t0 = time.perf_counter()
    testing.run_ranks(world, testing.call("td_vc_gan_tpu_torch.testing:step_rank",
                                          str(payload), str(out), device, backend),
                      timeout=DP_TIMEOUT)
    wall = time.perf_counter() - t0
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    dp_compare(label, results, ref)
    per = STAGES * 2
    for r, res in enumerate(results):
        if any(c != (per, per) for c in res["launches"]):
            raise AssertionError(f"{label}: rank {r} launched (K1, K2) {res['launches']} in "
                                 f"its steps, expected ({per}, {per}) each")
        bad = [k for m in res["metrics"] for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{label}: rank {r} logged non-finite {bad[:5]}")
        timed = sorted(res["ms"][1:])
        say(f"{label}: rank {r}/{world}: step median {timed[len(timed) // 2]:.2f} ms over "
            f"{len(timed)} steps (first {res['ms'][0]:.2f} ms), mean of G's and D's gradients "
            f"{res['all_reduce']['bytes'] / 1e6:.1f} MB in {res['all_reduce']['ms']:.2f} ms, "
            f"(K1, K2) launches per step {res['launches'][0]} [{card}]")
    say(f"{label}: {world} processes in {wall:.1f} s wall (start-up, load, steps)")
    return (sum(sum(c[0] for c in res["launches"]) for res in results),
            sum(sum(c[1] for c in res["launches"]) for res in results))


def phase_data_parallel(cfg, root: Path, card: str) -> dict:
    """Phase 21: (a) the full-width stage-2 step (16 x 8960, conv encoder,
    f32) on two ranks over gloo on cuda:0, 8 items each, against the
    one-rank step on the 16 items with the same weights and global draws;
    (b) the same on every visible card over NCCL, and with two or more the
    train CLI, one process per card, then a resume; (c) convert_long_sharded
    of a 60 s utterance on [cuda:0], [cuda:0, cuda:0] and every card,
    against the one-device output. Returns the launches for the kernel
    table."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        g, d, c = build_models(cfg, NUM_SPK, "cpu", seed=0)
        batch = {k: v.cpu().numpy() for k, v in train_batch(10).items()}
        payload = tmp / "payload.pt"
        torch.save(dict(cfg=cfg, G=g, D=d, C=c, crepe=crepe_from_seed(2), batch=batch,
                        draws=None, seed=5, steps=DP_STEPS), payload)
        del g, d, c

        # the one-rank step on the 16 items, no process group
        with IN_PROCESS_GPU:
            blob = torch.load(payload, weights_only=False)
            state = create_train_state(cfg, *(None if blob[k] is None else blob[k].cuda()
                                              for k in ("G", "D", "C", "crepe")))
            step = build_train_step(cfg, state)
            gen = torch.Generator(device="cuda").manual_seed(blob["seed"])
            full = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
            nets = [(tag, net, opt) for tag, net, opt in (
                ("G", state.G, state.opt_g), ("D", state.D, state.opt_d),
                ("C", state.C, state.opt_c)) if net is not None]
            ref = {"metrics": {k: float(v) for k, v in step(full, gen).items()},
                   "lr": {tag: opt.optimizer.param_groups[0]["lr"] for tag, _, opt in nets},
                   "state": {tag: {"params": {n: p.detach().cpu().clone()
                                              for n, p in net.named_parameters()},
                                   "exp_avg": {n: opt.optimizer.state[p]["exp_avg"].cpu().clone()
                                               for n, p in net.named_parameters()
                                               if p in opt.optimizer.state}}
                             for tag, net, opt in nets}}
            ms = []
            for _ in range(DP_STEPS - 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(full, gen)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ref["generator"] = gen.get_state()
            one_ms = sorted(ms)[len(ms) // 2]
            say(f"data parallel: one rank, no group: step median {one_ms:.2f} ms over {len(ms)} "
                f"steps, {B * 1e3 / one_ms:.2f} segments/s [{card}]")
            del state, step, full, blob
            gc.collect()
            torch.cuda.empty_cache()

        k1, k2 = dp_ranks("data parallel (a), 2 ranks over gloo on cuda:0", 2, payload,
                          tmp / "a", "cuda:0", "gloo", ref, card)
        world = torch.cuda.device_count()
        kb = dp_ranks(f"data parallel (b), {world} rank(s) over NCCL", world, payload,
                      tmp / "b", "cuda", "nccl", ref, card)
        k1, k2 = k1 + kb[0], k2 + kb[1]
        if world == 1:
            say("data parallel (b): one card, so this is the NCCL path at W = 1; it gives no "
                "scaling number")
        else:
            cli = dp_train_cli(root, world, card)
            k1, k2 = k1 + cli[0], k2 + cli[1]

    with IN_PROCESS_GPU:
        convert_k1 = dp_sharded_convert(cfg, card, world)
    say(f"data parallel: phase total {time.perf_counter() - t_phase:.1f} s")
    return {"train": (k1, k2), "convert": convert_k1}


def dp_train_cli(root: Path, world: int, card: str) -> tuple[int, int]:
    """The train CLI on ``world`` cards, one process each (epoch 0: 5 steps
    of 16 / world items on each rank, validation, a save, samples), then a
    resume for 2 steps; segments per second from rank 0's step lines.
    Returns the ranks' (K1, K2) launches (read from their Done lines)."""
    run = root / "run_dp"

    def command(extra):
        return lambda rank, world, address: [
            sys.executable, "-m", "td_vc_gan_tpu_torch.cli.train", "--save_path", str(run),
            "--data_path", str(root), "--num_processes", str(world), "--process_id", str(rank),
            "--coordinator_address", address,
            *[a for o in CLI_OVERRIDES for a in ("--override", o)], *extra]

    outs = [testing.run_ranks(world, command([]), timeout=DP_TIMEOUT),
            testing.run_ranks(world, command(["--load_path", str(run), "--max_steps", "7",
                                              "--override", "train.num_epoch=1"]),
                              timeout=DP_TIMEOUT)]
    first, second = ([out.splitlines() for out in run_outs] for run_outs in outs)
    steps = step_lines(first[0]) + step_lines(second[0])
    if [s["Itt"] for s in steps] != list(range(7)):
        raise AssertionError(f"multi-card CLI: logged steps {[s['Itt'] for s in steps]}")
    digest = re.search(r"digest (\w+)", one_line(first[0], "Saved epoch 0")[0]).group(1)
    k1 = k2 = 0
    for r in range(world):
        one_line(second[r], f"[rank {r}/{world}] Resumed train state epoch 0 (step 5, digest "
                            f"{digest}")
        for lines in (first[r], second[r]):
            done = one_line(lines, f"[rank {r}/{world}] Done at step")[0]
            k1 += int(re.search(r"K1 (\d+)", done).group(1))
            k2 += int(re.search(r"K2 (\d+)", done).group(1))
    counts = {(int(s["k1"]), int(s["k2"])) for s in steps}
    if counts != {(STAGES * 2, STAGES * 2)}:
        raise AssertionError(f"multi-card CLI: (K1, K2) per step {sorted(counts)}")
    ms = sorted(s["step_ms"] for s in steps if s["Itt"] not in (0, 5))
    median = ms[len(ms) // 2]
    say(f"data parallel (b): the train CLI on {world} cards (one process each, local batch "
        f"{B // world}): step median {median:.2f} ms, {B * 1e3 / median:.2f} segments/s in "
        f"all, {B * 1e3 / median / world:.2f} per rank; resumed on every rank from the state "
        f"saved at epoch 0 (digest {digest}) [{card}]")
    return k1, k2


def dp_sharded_convert(cfg, card: str, world: int) -> int:
    """convert_long_sharded of a LONG_S s utterance (17 chunks of 71680
    samples, overlap 12800) on [cuda:0], [cuda:0, cuda:0] and, with more
    cards, on every card: each output against the one-device output, RTF, K1
    launches (4 per shard call). Returns the K1 launches of the timed
    calls."""
    g = generator_from_config(cfg.model.generator, num_classes=NUM_SPK, seed=0)
    conv = Converter(cfg, g, crepe_from_seed(1), decoder="viterbi")
    sig = signals(3, LONG_S * 16000)[0]
    lists = [["cuda:0"], ["cuda:0", "cuda:0"]]
    if world > 1:
        lists.append(parallel.local_devices())
    for devices in lists:  # first calls: replicas, cuDNN's plans
        conv.convert_long_sharded(sig, 7, np.log(180.0), devices, seed=4)
    outs, total = [], 0
    for devices in lists:
        cc_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = conv.convert_long_sharded(sig, 7, np.log(180.0), devices, seed=4)
        wall = time.perf_counter() - t0
        launches = cc_mod.launches
        total += launches
        if launches != STAGES * len(devices):
            raise AssertionError(f"sharded convert on {devices}: {launches} K1 launches, "
                                 f"expected {STAGES} per shard call")
        if y.shape != sig.shape or not np.isfinite(y).all():
            raise AssertionError(f"sharded convert on {devices}: shape {y.shape} or non-finite")
        line = (f"sharded convert: {LONG_S} s on {devices}: {wall * 1e3:.1f} ms, RTF "
                f"{LONG_S / wall:.1f}x, K1 launches {launches} ({STAGES} per shard call), "
                f"max|y| {float(np.abs(y).max()):.4f}")
        if outs:
            d = np.abs(y - outs[0])
            worst = float((d / (SHARD_ATOL + SHARD_RTOL * np.abs(outs[0]))).max())
            line += (f"; against one device max|d| {float(d.max()):.2e} ({worst:.2f} of the "
                     f"tolerance atol {SHARD_ATOL:.0e} + rtol {SHARD_RTOL:.0e})")
            if worst > 1.0:
                raise AssertionError(f"sharded convert on {devices} differs from one device")
        outs.append(y)
        say(line + f" [{card}]")
    return total


# ---------------------------------------------------------------------------
# the generator's options: phase 22
# ---------------------------------------------------------------------------

# The options configuration: the config defaults plus a bottleneck of two
# FiLM blocks on the target speaker, instance norm in the encoder and
# conditional instance norm in the decoder.
OPTIONS = {"model": {"generator": {
    "num_bottleneck_layers": 2,
    "norm_layer": {"encoder": "instance_norm", "decoder": "conditional_instance_norm"}}}}
# The bottleneck's chain: the concat form at n = 1, E = Cc = 128 (on the
# target speaker; 256 on source and target), 2C = 256 (content width 128),
# T = 28 (a training segment) and 224 (a conversion utterance), B = 16.
BOTTLENECK_SHAPES = ((128, 28), (128, 224), (256, 28), (256, 224))
# The options step's first moments, kernel path vs plain-chain path: with
# norm slots in both stacks, tens of tensors (in the decoder's first MRF and
# the encoder's MRFs) have first moments of only 1e-4 to 1e-3 of G's
# largest, sums that the norms nearly cancel, and the two paths' rounding
# differs by up to ~1.2e-5 of G's largest there, 1-2e-2 of their own size
# (NVIDIA H100 80GB HBM3, 700 W; two runs). Each tensor is held to
# STEP_MU_RTOL of its own max|ref| or of this share of its net's largest,
# whichever is larger: to 1e-4 of the net's largest at least.
OPTIONS_MU_FLOOR = 1e-2
OPTIONS_F0_RTOL = 1e-4    # F0Estimator on the card against the CPU, of max|ref|


def options_cfg() -> Config:
    return load_config(None, OPTIONS)


def bottleneck_operands(b: int, t: int, cc: int, seed: int, dtype) -> dict:
    """The concat-form operands of one bottleneck block's chain: a cond that
    is one (B, Cc) vector broadcast over T, as the block's, and n = 1; dyadic
    as ``chain_inputs(exact_h=True)`` makes them."""
    cfg = Config()
    g = cfg.model.generator
    g.conditional_dim, g.mrf_kernel_sizes, g.mrf_dilations = cc, [3], [1]
    _, concat, _, _ = chain_inputs(b, t, 128, cfg, seed, exact_h=True, e=0, dtype=dtype)
    return concat


def bottleneck_kernels(card, b: int, t: int, cc: int, seed: int) -> dict:
    """K1, K2, K1-bf16 and K2-bf16 at one bottleneck shape: each against its
    plain version (f32: PARITY_RTOL of max|ref|; bf16: ``ulp_parity``), the
    backward kernels bit for bit in a second run; then each one's time
    through the wrapper and through its C entry point (``old_k1``,
    ``old_k2`` on this tree's libraries: at these sizes the wrapper's host
    work is as long as the kernels) beside its bound, its plain version and
    cuDNN's calls for the same chain (a yardstick). Returns {kernel name:
    (max|d|, numbers for Totals and c_entry_ms)}."""
    out = {}
    libs = cc_mod._library()
    two_c = 256
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        ops = wide_operands(None, b, t, cc, two_c, 1, seed, dtype)
        c, w0, b0, w1, b1, g = (ops[k] for k in ("c", "w0", "b0", "w1", "b1", "g"))
        bwd_args = dict(exc=c, w0=w0, hbias=b0, w1=w1, g=g, edge0=None, edge_t=None)
        fwd = lambda: cc_mod.film_cond_chain(c, w0, b0, w1, b1)  # noqa: E731
        fwd_plain = lambda: cc_mod.cond_chain_plain(c, w0, b0, w1, b1)  # noqa: E731
        bwd = lambda: cc_mod._launch_bwd(**bwd_args)  # noqa: E731
        bwd_plain = lambda: cc_mod.cond_chain_bwd_plain(**bwd_args)  # noqa: E731
        fwd_ops = dict(exc=c, w0=w0, hbias=b0, w1=w1, b1=b1, edge0=None, edge_t=None)
        k2_ops = {k: v for k, v in bwd_args.items() if k != "g"}
        c_entry = {"fwd": lambda: old_k1(libs["fwd" + suffix], fwd_ops),
                   "bwd": lambda: old_k2(libs["bwd" + suffix], k2_ops, g)}
        label = f"B={b} T={t} Cc=E={cc} 2C={two_c} n=1"
        pairs = [("fwd", fwd(), fwd_plain())]
        got, again, want = bwd(), bwd(), bwd_plain()
        for k in want:
            if not torch.equal(got[k], again[k]):
                raise AssertionError(f"K2{suffix} gave two different d{k} at {label}")
            pairs.append((f"d{k}", got[k], want[k]))
        errs = {}
        for part, a, w in pairs:
            kernel = "fwd" if part == "fwd" else "bwd"
            if dtype == torch.float32:
                d, r = rel_err(a, w)
                if not r <= PARITY_RTOL:
                    raise AssertionError(f"bottleneck {kernel} kernel at {label}, {part}: "
                                         f"{r:.2e} of max|ref|")
            else:
                _, _, d = ulp_parity(f"bottleneck {kernel}{suffix} at {label}, {part}", a, w)
            errs[kernel] = max(errs.get(kernel, 0.0), d)
        cudnn_fwd, cudnn_bwd = cudnn_chain(ops, 1)
        size = 4 if dtype == torch.float32 else 2
        weights_ = 3 * cc * cc + cc + 3 * cc * two_c + two_c
        work = {"fwd": (2.0 * b * t * 3 * cc * (cc + two_c),
                        size * (b * t * cc + weights_ + b * t * two_c)),
                "bwd": (2.0 * b * t * 3 * cc * (3 * cc + 2 * two_c),
                        size * (2 * b * t * cc + 2 * weights_ - two_c + b * t * two_c))}
        for kernel, fn, plain, lib in (("fwd", fwd, fwd_plain, cudnn_fwd),
                                       ("bwd", bwd, bwd_plain, cudnn_bwd)):
            k_ms = cuda_ms(fn, iters=20, warmup=3)
            c_ms = cuda_ms(c_entry[kernel], iters=20, warmup=3)
            p_ms = cuda_ms(plain, iters=5)
            l_ms = cuda_ms(lib, iters=5)
            flops, nbytes = work[kernel]
            if dtype == torch.float32:
                bound, bound_simt, by = bounds(flops, nbytes)
                bound_text = (f"bound {bound:.4f} ms ({by}, 3xTF32) / {bound_simt:.4f} ms (f32 "
                              f"CUDA cores)")
            else:
                (bound, by), bound_simt = bf16_bounds(flops, nbytes), 0.0
                bound_text = f"bound {bound:.4f} ms ({by}, bf16 tensor cores)"
            name = f"cond_chain_{kernel}{suffix}"
            say(f"options {name} {label}: kernel {k_ms:.4f} ms through the wrapper, "
                f"{c_ms:.4f} ms through its C entry point, {bound_text}, plain "
                f"{p_ms:.4f} ms, cuDNN {l_ms:.4f} ms; max|d| vs plain {errs[kernel]:.2e} "
                f"[{card}]")
            out[name] = (errs[kernel], dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                            bound_simt_ms=bound_simt, library_ms=l_ms,
                                            flops=flops, bytes=nbytes, c_entry_ms=c_ms))
        del ops, c, w0, b0, w1, b1, g, bwd_args, pairs, got, again, want, cudnn_bwd
        del fwd_ops, k2_ops, c_entry
        torch.cuda.empty_cache()
    return out


def options_f0_estimator(card) -> float:
    """(e): F0Estimator at its default width from a seed, on the card against
    the CPU on 4 x 8960 samples; returns max|d| of max|ref|."""
    net = init_weights(F0Estimator(), seed=3)
    x = torch.from_numpy(signals(4, SEG)[:4, :, None])
    with torch.no_grad():
        ref = net(x)
        got = net.cuda()(x.cuda())
    worst = max(rel_err(a.cpu(), b)[1] for a, b in zip(got, ref))
    if not worst <= OPTIONS_F0_RTOL:
        raise AssertionError(f"F0Estimator: card vs CPU {worst:.2e} of max|ref|")
    say(f"options F0Estimator: {sum(p.numel() for p in net.parameters())} parameters, "
        f"(f0, voiced) {tuple(got[0].shape)} each from {len(x)} x {SEG}; card vs CPU worst "
        f"{worst:.2e} of max|ref| (tolerance {OPTIONS_F0_RTOL:.0e}) [{card}]")
    return worst


def phase_options(card, convert_ms: float, step_ms: float) -> dict:
    """Phase 22: the options configuration at full width. (a) K1, K2,
    K1-bf16 and K2-bf16 at the bottleneck's shapes; (b) f32 conversion of
    phase 4's batch; (c) the f32 train step at 16 x 8960 (two decodes of
    decoder stages + bottleneck blocks a step); (d) bf16 conversion; (e)
    F0Estimator. Returns the launches by path and the bottleneck's kernel
    numbers by kernel name and shape."""
    t_phase = time.perf_counter()
    ocfg = options_cfg()
    gcfg = ocfg.model.generator
    say(f"options: the config defaults plus num_bottleneck_layers={gcfg.num_bottleneck_layers}, "
        f"norm_layer.encoder={gcfg.norm_layer.encoder}, "
        f"norm_layer.decoder={gcfg.norm_layer.decoder}")
    kernels: dict = {}
    for i, (cc, t) in enumerate(BOTTLENECK_SHAPES):
        for name, (err, nums) in bottleneck_kernels(card, B, t, cc, 2200 + i).items():
            kernels.setdefault(name, {})[f"Cc{cc}_T{t}"] = dict(max_abs_err=err, **nums)
    convert_k1, ms = phase_slice(ocfg, card, "options convert")
    say(f"options convert: {ms:.2f} ms per call against phase 4's {convert_ms:.2f} ms "
        f"({ms / convert_ms - 1:+.1%}) [{card}]")
    per_step = 2 * (len(gcfg.decoder_ratios) + gcfg.num_bottleneck_layers)
    (train_k1, train_k2), median = phase_step("options train", ocfg, card, per_step, steps=3,
                                              mu_floor=OPTIONS_MU_FLOOR)
    say(f"options train: median {median:.2f} ms per step against phase 7's {step_ms:.2f} ms "
        f"({median / step_ms - 1:+.1%}) [{card}]")
    bf16_k1 = phase_bf16_convert(ocfg, card, ("conv",), "options bf16 convert")
    options_f0_estimator(card)
    say(f"options: phase 22 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"launches": {"options_convert": convert_k1, "options_train": (train_k1, train_k2),
                         "options_bf16_convert": bf16_k1},
            "bottleneck": kernels}


AB_ROUNDS = 5


def ab_libraries(src_dir: Path, out_dir: Path) -> tuple[dict, str]:
    """The earlier libraries, built from their sources in ``src_dir`` (the
    four .cu files of SOURCES and BF16_SOURCES and the headers they include,
    with this tree's C interface, which the f32 kernels have had since
    their Hopper redesign: K1 with a workspace, K2 on W1 in its own layout)
    into ``out_dir`` with the package's nvcc flags, all started together;
    ({"fwd", "bwd", "fwd_bf16", "bwd_bf16"}: ctypes library, nvcc's output)."""
    jobs = [(src_dir / s.name, out_dir / f"{s.stem}.so")
            for s in cc_mod.SOURCES + cc_mod.BF16_SOURCES]
    procs = [subprocess.Popen([cc_mod._nvcc(), *cc_mod.NVCC_FLAGS, "-o", str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, lib in jobs]
    log = []
    for (src, _), proc in zip(jobs, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        log.append(out)
    libs = dict(zip(cc_mod._LIBS, (ctypes.CDLL(str(lib)) for _, lib in jobs)))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = libs["fwd"]
    fwd.cond_chain_fwd_f32.argtypes = [p, p, p, ll, p, p, p, p, p, p, ll, i, i, i, i, i, i, p]
    fwd.cond_chain_fwd_f32.restype = i
    fwd.cond_chain_fwd_f32_workspace.argtypes = [i] * 6
    fwd.cond_chain_fwd_f32_workspace.restype = ll
    bwd = libs["bwd"]
    bwd.cond_chain_bwd_workspace.argtypes = [i] * 7
    bwd.cond_chain_bwd_workspace.restype = ll
    bwd.cond_chain_bwd_f32.argtypes = [p, p, p, ll, p, p, p, p, p, p, p, p, p, p, p, p, ll,
                                       i, i, i, i, i, i, p]
    bwd.cond_chain_bwd_f32.restype = i
    fwd = libs["fwd_bf16"]
    fwd.cond_chain_fwd_bf16.argtypes = [p, p, p, ll, p, p, p, p, p, p, ll, i, i, i, i, i, i, p]
    fwd.cond_chain_fwd_bf16.restype = i
    fwd.cond_chain_fwd_bf16_workspace.argtypes = [i] * 5
    fwd.cond_chain_fwd_bf16_workspace.restype = ll
    bwd = libs["bwd_bf16"]
    bwd.cond_chain_bwd_bf16_workspace.argtypes = [i] * 6
    bwd.cond_chain_bwd_bf16_workspace.restype = ll
    bwd.cond_chain_bwd_bf16.argtypes = [p, p, p, ll, p, p, p, p, p, p, p, p, p, p, p, p, ll,
                                        i, i, i, i, i, i, p]
    bwd.cond_chain_bwd_bf16.restype = i
    return libs, "\n".join(log)


def ptr(x):
    return None if x is None else x.data_ptr()


def old_k1(fwd, split: dict):
    """The earlier K1 (f32 operands) or K1-bf16 (bf16) on split-form
    operands, with the workspace each takes."""
    exc, w0, hbias, w1, b1 = (split[k] for k in ("exc", "w0", "hbias", "w1", "b1"))
    b, t, e, n, cc, two_c = cc_mod._dims(exc, w0, w1)
    out = torch.empty((b, t, n * two_c), device=exc.device, dtype=exc.dtype)
    args = (ptr(exc), ptr(w0), ptr(hbias), n * cc if hbias.dim() == 2 else 0,
            ptr(split["edge0"]), ptr(split["edge_t"]), ptr(w1), ptr(b1), ptr(out))
    if exc.dtype == torch.float32:
        nbytes = fwd.cond_chain_fwd_f32_workspace(b, e, n, cc, two_c, 1)
        launch = fwd.cond_chain_fwd_f32
    else:
        nbytes = fwd.cond_chain_fwd_bf16_workspace(b, e, n, cc, two_c)
        launch = fwd.cond_chain_fwd_bf16
    ws = torch.empty(int(nbytes), device=exc.device, dtype=torch.uint8)
    err = launch(*args, ptr(ws), ws.numel(), b, t, e, n, cc, two_c,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier forward kernel failed to launch ({err})")
    return out


def old_k2(bwd, args: dict, g, guard: int = 0):
    """The earlier K2 (f32 operands, a workspace in floats) or K2-bf16 (bf16,
    in bytes) on split-form operands: the gradients' dict. ``guard``: each
    output is followed by that many elements of GUARD_WORD, which the call
    must leave as they were."""
    exc, w0, hbias, w1 = (args[k] for k in ("exc", "w0", "hbias", "w1"))
    b, t, e, n, cc, two_c = cc_mod._dims(exc, w0, w1)
    shapes = {k: args[k].shape for k in ("exc", "w0", "hbias", "w1", "edge0", "edge_t")
              if args[k] is not None}
    shapes["b1"] = (n * two_c,)
    if guard:
        bufs = {k: torch.full((int(np.prod(v)) + guard,), GUARD_WORD, device=exc.device,
                              dtype=exc.dtype) for k, v in shapes.items()}
        out = {k: bufs[k][:-guard].view(v) for k, v in shapes.items()}
    else:
        out = {k: torch.empty(v, device=exc.device, dtype=exc.dtype) for k, v in shapes.items()}
    if exc.dtype == torch.float32:
        ws = torch.empty(int(bwd.cond_chain_bwd_workspace(b, t, e, n, cc, two_c, 1)),
                         device=exc.device, dtype=torch.float32)
        launch = bwd.cond_chain_bwd_f32
    else:
        ws = torch.empty(int(bwd.cond_chain_bwd_bf16_workspace(b, t, e, n, cc, two_c)),
                         device=exc.device, dtype=torch.uint8)
        launch = bwd.cond_chain_bwd_bf16
    err = launch(
        ptr(exc), ptr(w0), ptr(hbias), n * cc if hbias.dim() == 2 else 0, ptr(args["edge0"]),
        ptr(args["edge_t"]), ptr(w1),
        ptr(g), ptr(out["exc"]), ptr(out["w0"]), ptr(out["hbias"]), ptr(out.get("edge0")),
        ptr(out.get("edge_t")), ptr(out["w1"]), ptr(out["b1"]), ptr(ws), ws.numel(),
        b, t, e, n, cc, two_c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier backward kernels failed to launch ({err})")
    for k in shapes if guard else ():
        if not torch.equal(bufs[k][-guard:], torch.full_like(bufs[k][-guard:], GUARD_WORD)):
            raise AssertionError(f"K2 wrote past the end of d{k}")
    return out


def ab_times(old_fn, new_fn, iters: int) -> dict:
    """{"old": [ms], "new": [ms]} over AB_ROUNDS rounds, alternated."""
    fns, res = {"old": old_fn, "new": new_fn}, {"old": [], "new": []}
    for r in range(AB_ROUNDS):
        for k in ("old", "new") if r % 2 == 0 else ("new", "old"):
            res[k].append(cuda_ms(fns[k], iters=iters, warmup=1))
    return res


def ab_summary(per_shape: list[dict]) -> dict:
    """Per version: the per-round totals over the shapes, their median, min
    and max."""
    out = {}
    for k in ("old", "new"):
        tot = sorted(sum(x[k][r] for x in per_shape) for r in range(AB_ROUNDS))
        out[k] = {"median": tot[len(tot) // 2], "min": tot[0], "max": tot[-1], "rounds": tot}
    return out


def ab_f32_agree(label: str, new, old) -> None:
    """The two f32 versions' outputs within PARITY_RTOL of max|old|."""
    _, r = rel_err(new, old)
    if not r <= PARITY_RTOL:
        raise AssertionError(f"{label}: the two versions differ by {r:.2e} of max|old|")


def ab_pair(cfg, card, fwd, bwd, dtype) -> dict:
    """The earlier forward and backward kernels of one dtype (libraries
    ``fwd``, ``bwd``) against this tree's, alternated for AB_ROUNDS rounds,
    at the conversion's four stage shapes (K1) and the train step's eight
    (K1, K2; f32 at batch 16, bf16 at batch 64), the outputs of the two
    versions held to each other (f32 within PARITY_RTOL of max|old|, bf16
    within one bf16 ulp, as phase 14), the backward's time by kernel
    (torch.profiler, as the earlier library has no timing events) and its
    workspace at the step's largest call; returns the summaries by path."""
    f32 = dtype == torch.float32
    name = "" if f32 else "-bf16"
    bsz = B if f32 else B64
    paths = {"k1 convert": [], "k1 train": [], "k2 train": []}
    parts: dict = {"old": {}, "new": {}}
    k1_parts: dict = {"old": {}, "new": {}}
    seed = 700 if f32 else 1750
    shapes = [("convert", B, t, c, 1700 + i) for i, (t, c) in enumerate(stage_shapes(UTT, cfg))]
    shapes += [("train", b, t, c, seed + i) for b in (2 * bsz, bsz)
               for i, (t, c) in enumerate(stage_shapes(SEG, cfg))]

    def agree(label, new, old):
        if f32:
            ab_f32_agree(label, new, old)
        else:
            ulp_parity(label, new, old)

    for path, b, t, c, seed in shapes:
        split, _, n, cc = chain_inputs(b, t, c, cfg, seed=seed, exact_h=True, dtype=dtype)
        agree(f"ab K1{name} B={b} T={t}", cc_mod.cond_chain(**split), old_k1(fwd, split))
        k1 = ab_times(lambda: old_k1(fwd, split), lambda: cc_mod.cond_chain(**split), iters=3)
        paths[f"k1 {path}"].append(k1)
        line = (f"ab B={b} T={t} C={c}: K1{name} old {np.median(k1['old']):.3f} ms, new "
                f"{np.median(k1['new']):.3f} ms")
        if path == "convert" and f32:
            for version, fn in (("old", lambda: old_k1(fwd, split)),
                                ("new", lambda: cc_mod.cond_chain(**split))):
                part = kernel_breakdown(fn)
                add_breakdown(k1_parts[version], part)
                say(f"ab k1 kernels ({version}) B={b} T={t} C={c}: {breakdown_line(part)} "
                    f"[{card}]")
        if path == "train":
            g = cotangent(split, seed=seed + 50).to(dtype)
            args = {k: v for k, v in split.items() if k != "b1"}
            new, old = cc_mod._launch_bwd(g=g, **args), old_k2(bwd, args, g)
            for k in new:
                agree(f"ab K2{name} B={b} T={t} d{k}", new[k], old[k])
            del new, old
            k2 = ab_times(lambda: old_k2(bwd, args, g), lambda: cc_mod._launch_bwd(g=g, **args),
                          iters=2)
            paths["k2 train"].append(k2)
            line += (f"; K2{name} old {np.median(k2['old']):.3f} ms, new "
                     f"{np.median(k2['new']):.3f} ms")
            for version, fn in (("old", lambda: old_k2(bwd, args, g)),
                                ("new", lambda: cc_mod._launch_bwd(g=g, **args))):
                part = kernel_breakdown(fn)
                add_breakdown(parts[version], part)
                say(f"ab k2{name} kernels ({version}) B={b} T={t} C={c}: "
                    f"{breakdown_line(part)} [{card}]")
            del g, args
        say(line + f" [{card}]")
        del split
        torch.cuda.empty_cache()
    if f32:
        ws_shape, per = K2_WS_SHAPE, "train step"
        ws = {"old": 4 * bwd.cond_chain_bwd_workspace(*ws_shape, 1),
              "new": 4 * cc_mod._library()["bwd"].cond_chain_bwd_workspace(*ws_shape, 1)}
    else:
        ws_shape, per = K2B_WS_SHAPE, "batch-64 train step"
        ws = {"old": bwd.cond_chain_bwd_bf16_workspace(*ws_shape),
              "new": cc_mod._library()["bwd_bf16"].cond_chain_bwd_bf16_workspace(*ws_shape)}
    for version in ("old", "new"):
        if f32:
            say(f"ab k1 kernels ({version}) per convert call (4 calls): "
                f"{breakdown_line(k1_parts[version], 4)} [{card}]")
        say(f"ab k2{name} kernels ({version}) per {per} (8 calls): "
            f"{breakdown_line(parts[version], 8)}; workspace at (B, T, E, n, Cc, 2C) = "
            f"{ws_shape}: {ws[version] / 1e9:.3f} GB [{card}]")
    out = {k: ab_summary(v) for k, v in paths.items()}
    for k, v in out.items():
        say(f"ab {k}{name} ({len(paths[k])} shapes, {AB_ROUNDS} rounds alternated): old median "
            f"{v['old']['median']:.3f} ms (min {v['old']['min']:.3f}, max {v['old']['max']:.3f}), "
            f"new median {v['new']['median']:.3f} ms (min {v['new']['min']:.3f}, max "
            f"{v['new']['max']:.3f}); new/old {v['new']['median'] / v['old']['median']:.3f} "
            f"[{card}]")
    return out


def wide_shapes(cfg) -> list[tuple[str, int, int, int, int, int]]:
    """The concat-form shapes where K1-bf16 and K2 (f32) lost to cuDNN in
    their earlier versions (``PERF.md`` section 6), as (label, B, T,
    Cc = E, 2C, n): the
    bottleneck's four (BOTTLENECK_SHAPES, B = 16, n = 1) and phase 6's
    E = Cc = 600 (B = 2, the second stage's T and 2C, n = 9)."""
    t, c = stage_shapes(SEG, cfg)[1]
    out = [(f"bottleneck Cc=E={cc} T={tt}", B, tt, cc, 256, 1) for cc, tt in BOTTLENECK_SHAPES]
    return out + [(f"wide Cc=E=600 T={t}", 2, t, 600, 2 * c, 9)]


def wide_operands(cfg, b: int, t: int, cc: int, two_c: int, n: int, seed: int, dtype) -> dict:
    """Concat-form operands (``chain_inputs(exact_h=True)``) at one of
    ``wide_shapes``: c, w0, b0, w1, b1 and a cotangent g (n = 1: the
    bottleneck's, 2C = 256, ``cfg`` unused)."""
    if n == 1:
        ops = bottleneck_operands(b, t, cc, seed, dtype)
    else:
        wcfg = copy.deepcopy(cfg)
        wcfg.model.generator.conditional_dim = cc - 8
        _, ops, _, _ = chain_inputs(b, t, two_c // 2, wcfg, seed, exact_h=True, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ops["g"] = torch.randn((b, t, n * two_c), generator=gen, device="cuda").to(dtype)
    return ops


def cudnn_chain(ops: dict, n: int):
    """cuDNN's calls for the chain on concat-form operands (conv1d, leaky_relu,
    grouped conv1d; a yardstick the port never calls): (forward, backward of
    the same chain for ``ops["g"]``)."""
    cin = ops["c"].transpose(1, 2).contiguous()
    w0c, w1c = ops["w0"].permute(2, 1, 0), ops["w1"].permute(2, 1, 0)

    def fwd(x=cin, a0=w0c, c0=ops["b0"], a1=w1c, c1=ops["b1"]):
        return F.conv1d(F.leaky_relu(F.conv1d(x, a0, c0, padding=1), 0.2), a1, c1, padding=1,
                        groups=n)

    leaves = [x.clone().requires_grad_() for x in (cin, w0c, ops["b0"], w1c, ops["b1"])]
    out, gt = fwd(*leaves), ops["g"].transpose(1, 2)
    return fwd, lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True)


def ab_wide(cfg, card, fwd32, fwd_bf16, bwd, bwd_bf16) -> dict:
    """K1 (f32), K1-bf16, K2 (f32) and K2-bf16 earlier (libraries ``fwd32``,
    ``fwd_bf16``, ``bwd``, ``bwd_bf16``) against this tree's at
    ``wide_shapes``, alternated, each version's outputs held to the other's,
    cuDNN's forward (f32, bf16) and backward (f32, bf16) of the same chain
    beside them, and each backward's
    time by kernel for each version; returns {label: {kernel: times}}.
    Both versions are called the same way, through their C entry points
    (``old_k1``, ``old_k2``): at these sizes a call's host work is as long as
    its kernels."""
    libs = cc_mod._library()
    out = {}
    for k, (label, b, t, cc, two_c, n) in enumerate(wide_shapes(cfg)):
        ops = wide_operands(cfg, b, t, cc, two_c, n, 3300 + k, torch.bfloat16)
        fwd = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"], b1=ops["b1"],
                   edge0=None, edge_t=None)
        # both K1-bf16s on E as the wrapper pads it (the earlier one, since its
        # redesign for wide E, takes E in the same multiples)
        padded = dict(fwd)
        padded["exc"], padded["w0"] = cc_mod._pad_exc(fwd["exc"], fwd["w0"],
                                                      cc_mod._padded_e("fwd_bf16", cc))
        ulp_parity(f"ab K1-bf16 {label}", old_k1(libs["fwd_bf16"], padded),
                   old_k1(fwd_bf16, padded))
        k1 = ab_times(lambda: old_k1(fwd_bf16, padded), lambda: old_k1(libs["fwd_bf16"], padded),
                      iters=5)
        l1 = cuda_ms(cudnn_chain(ops, n)[0], iters=5)
        del ops, fwd, padded
        ops = wide_operands(cfg, b, t, cc, two_c, n, 3300 + k, torch.float32)
        args = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"], edge0=None,
                    edge_t=None)
        f32 = dict(args, b1=ops["b1"])
        ab_f32_agree(f"ab K1 {label}", old_k1(libs["fwd"], f32), old_k1(fwd32, f32))
        k1f = ab_times(lambda: old_k1(fwd32, f32), lambda: old_k1(libs["fwd"], f32), iters=5)
        l1f = cuda_ms(cudnn_chain(ops, n)[0], iters=5)
        for version, fn in (("old", lambda: old_k1(fwd32, f32)),
                            ("new", lambda: old_k1(libs["fwd"], f32))):
            say(f"ab k1 kernels ({version}) {label}: {breakdown_line(kernel_breakdown(fn))} "
                f"[{card}]")
        new, old = old_k2(libs["bwd"], args, ops["g"]), old_k2(bwd, args, ops["g"])
        for key in new:
            ab_f32_agree(f"ab K2 {label} d{key}", new[key], old[key])
        del new, old
        k2 = ab_times(lambda: old_k2(bwd, args, ops["g"]),
                      lambda: old_k2(libs["bwd"], args, ops["g"]), iters=3)
        l2 = cuda_ms(cudnn_chain(ops, n)[1], iters=3)
        for version, fn in (("old", lambda: old_k2(bwd, args, ops["g"])),
                            ("new", lambda: old_k2(libs["bwd"], args, ops["g"]))):
            say(f"ab k2 kernels ({version}) {label}: {breakdown_line(kernel_breakdown(fn))} "
                f"[{card}]")
        del ops, args, f32
        torch.cuda.empty_cache()
        ops = wide_operands(cfg, b, t, cc, two_c, n, 3300 + k, torch.bfloat16)
        args = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"], edge0=None,
                    edge_t=None)
        new, old = old_k2(libs["bwd_bf16"], args, ops["g"]), old_k2(bwd_bf16, args, ops["g"])
        for key in new:
            ulp_parity(f"ab K2-bf16 {label} d{key}", new[key], old[key])
        del new, old
        k2b = ab_times(lambda: old_k2(bwd_bf16, args, ops["g"]),
                       lambda: old_k2(libs["bwd_bf16"], args, ops["g"]), iters=3)
        l2b = cuda_ms(cudnn_chain(ops, n)[1], iters=3)
        for version, fn in (("old", lambda: old_k2(bwd_bf16, args, ops["g"])),
                            ("new", lambda: old_k2(libs["bwd_bf16"], args, ops["g"]))):
            say(f"ab k2-bf16 kernels ({version}) {label}: "
                f"{breakdown_line(kernel_breakdown(fn))} [{card}]")
        say(f"ab {label}: K1 old {np.median(k1f['old']):.4f} ms, new "
            f"{np.median(k1f['new']):.4f} ms, cuDNN {l1f:.4f} ms; K1-bf16 old "
            f"{np.median(k1['old']):.4f} ms, new "
            f"{np.median(k1['new']):.4f} ms, cuDNN bf16 {l1:.4f} ms; K2 old "
            f"{np.median(k2['old']):.4f} ms, new {np.median(k2['new']):.4f} ms, cuDNN backward "
            f"{l2:.4f} ms; K2-bf16 old {np.median(k2b['old']):.4f} ms, new "
            f"{np.median(k2b['new']):.4f} ms, cuDNN bf16 backward {l2b:.4f} ms ({AB_ROUNDS} "
            f"rounds alternated, medians) [{card}]")
        out[label] = {"k1": k1f, "k1_cudnn_ms": l1f, "k1_bf16": k1, "k1_bf16_cudnn_ms": l1,
                      "k2": k2, "k2_cudnn_ms": l2,
                      "k2_bf16": k2b, "k2_bf16_cudnn_ms": l2b}
        del ops, args
        torch.cuda.empty_cache()
    return out


def phase_ab(cfg, card, src_dir: Path) -> dict:
    """The earlier kernels (built from ``src_dir``) against this tree's: the
    f32 pair (K1, K2), then the bf16 pair (K1-bf16, K2-bf16) (``ab_pair``),
    then all four at wide E (``ab_wide``); returns the summaries by dtype and
    path."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs, log = ab_libraries(src_dir, Path(tmp))
        say(f"ab: the earlier libraries built in {time.perf_counter() - t0:.1f} s; "
            + " | ".join(ptxas_summary(log)))
        return {"f32": ab_pair(cfg, card, libs["fwd"], libs["bwd"], torch.float32),
                "bf16": ab_pair(cfg, card, libs["fwd_bf16"], libs["bwd_bf16"], torch.bfloat16),
                "wide": ab_wide(cfg, card, libs["fwd"], libs["fwd_bf16"], libs["bwd"],
                                libs["bwd_bf16"])}


def timer_libraries(tmp: Path) -> dict:
    """This tree's K1 (f32), K1-bf16, K2 (f32) and K2-bf16 built with
    -DCOND_CHAIN_TIMERS into ``tmp``, the four nvcc runs started together;
    {"fwd", "fwd_bf16", "bwd", "bwd_bf16": ctypes library with its timer
    reader's argtypes}."""
    srcs = {"fwd": cc_mod.SOURCES[0], "fwd_bf16": cc_mod.BF16_SOURCES[0],
            "bwd": cc_mod.SOURCES[1], "bwd_bf16": cc_mod.BF16_SOURCES[1]}
    procs = {name: subprocess.Popen([cc_mod._nvcc(), *cc_mod.NVCC_FLAGS, "-DCOND_CHAIN_TIMERS",
                                     "-o", str(tmp / f"{name}_timers.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in srcs.items()}
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {srcs[name]} with timers:\n{out}")
        libs[name] = lib = ctypes.CDLL(str(tmp / f"{name}_timers.so"))
    lib = libs["fwd"]
    lib.cond_chain_fwd_f32.argtypes = [p, p, p, ll, p, p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.cond_chain_fwd_f32.restype = i
    lib.cond_chain_fwd_f32_workspace.argtypes = [i] * 6
    lib.cond_chain_fwd_f32_workspace.restype = ll
    lib.timers = lib.cond_chain_fwd_f32_timers
    lib = libs["fwd_bf16"]
    lib.cond_chain_fwd_bf16.argtypes = [p, p, p, ll, p, p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.cond_chain_fwd_bf16.restype = i
    lib.cond_chain_fwd_bf16_workspace.restype = ll
    lib.timers = lib.cond_chain_fwd_bf16_timers
    lib = libs["bwd"]
    lib.cond_chain_bwd_workspace.argtypes = [i] * 7
    lib.cond_chain_bwd_workspace.restype = ll
    lib.cond_chain_bwd_f32.argtypes = [p, p, p, ll, p, p, p, p, p, p, p, p, p, p, p, p, ll,
                                       i, i, i, i, i, i, p]
    lib.cond_chain_bwd_f32.restype = i
    lib.timers = lib.cond_chain_bwd_timers
    lib = libs["bwd_bf16"]
    lib.cond_chain_bwd_bf16_workspace.argtypes = [i] * 6
    lib.cond_chain_bwd_bf16_workspace.restype = ll
    lib.cond_chain_bwd_bf16.argtypes = [p, p, p, ll, p, p, p, p, p, p, p, p, p, p, p, p, ll,
                                        i, i, i, i, i, i, p]
    lib.cond_chain_bwd_bf16.restype = i
    lib.timers = lib.cond_chain_bwd_bf16_timers
    for lib in libs.values():
        lib.timers.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), i]
        lib.timers.restype = i
    return libs


def read_timers(lib, n: int, fn, reps: int = 5) -> tuple[float, list[float]]:
    """(ms a launch of ``fn``, the ``n`` cycle sums of ``reps`` launches) from
    a timer library (its reader copies all its counters: up to TIMER_SLOTS)."""
    cyc = (ctypes.c_ulonglong * max(n, TIMER_SLOTS))()
    lib.timers(cyc, 1)
    ms = cuda_ms(fn, iters=reps, warmup=0)
    if lib.timers(cyc, 1):
        raise RuntimeError("the timers could not be read")
    return ms, [float(x) for x in cyc[:n]]


TIMER_SLOTS = 64  # more than any timer build's counters


# the phases the timer builds count, in the order of their cycle sums; a
# part of the phase before it is not counted again in "other" (K2-bf16's h
# at E = 8: the wait for the product, issued within dexc's shift and store)
K2B_PHASES = ("h", "da", "da's waits on full", "slope+dh", "dexc+X^T dh",
              "their products", "X^T dh's sum", "dexc's shift and store")
K2_PHASES = ("h", "da", "da's waits on full", "dh", "dexc", "X^T dh", "dexc's store")
K1_PHASES = ("h", "h's waits on full", "A", "barriers", "P", "P's waits on full", "output")
# the weight-grad kernels' (k2b_w1_kernel, k2_w1_kernel) counters after the
# data kernel's, by role: each role's phases, its whole and its count
K2B_W1_PHASES = (("compute warpgroup",
                  ("X", "image waits", "waits on g_full", "products' issue",
                   "wait for the products and h", "lrelu and a's store", "barrier",
                   "partials' store")),
                 ("producer thread", ("waits on empty",)))
K2_W1_PHASES = (("warpgroup",
                 ("X's image", "h (waits on X and Wh, products, wait)", "a's store",
                  "waits on g_full", "products (A fragments, issue, waits on the slice before)",
                  "wait after the products", "run sums and partials", "barrier")),)
PHASE_PARTS = {"da's waits on full", "their products", "X^T dh's sum",
               "dexc's shift and store", "h's waits on full"}


def k1_timer_cases(cfg) -> list[tuple[str, int, int, int | None, int, int | None]]:
    """K1 (f32)'s timed shapes, as ``wide_shapes``' (label, B, T, Cc = E, 2C,
    n), Cc None for the split form at a decoder stage (C = 2C / 2): the f32
    conversion's four stages (B = 16), the f32 step's B = 32 four and the
    bottleneck's Cc = E = 256 at T = 28 and 224."""
    cases = [(f"convert stage {k} C={c}", B, t, None, 2 * c, None)
             for k, (t, c) in enumerate(stage_shapes(UTT, cfg))]
    cases += [(f"step stage {k} C={c}", 2 * B, t, None, 2 * c, None)
              for k, (t, c) in enumerate(stage_shapes(SEG, cfg))]
    return cases + [x for x in wide_shapes(cfg) if x[-1] == 1 and x[3] == 256]


def k1_f32_timers(cfg, card, lib) -> None:
    """K1 (f32) from its timer build at ``k1_timer_cases``: each launch held
    to the plain version, then each consumer warpgroup's cycles by phase
    (K1_PHASES) as shares of its whole, and the producer's waits on empty as a
    share of its cycles."""
    for k, (label, b, t, cc, two_c, n) in enumerate(k1_timer_cases(cfg)):
        if cc is None:
            fwd, _, _, _ = chain_inputs(b, t, two_c // 2, cfg, seed=3700 + k)
        else:
            ops = wide_operands(cfg, b, t, cc, two_c, n, 3700 + k, torch.float32)
            fwd = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"],
                       b1=ops["b1"], edge0=None, edge_t=None)
            del ops
        ab_f32_agree(f"timers K1 (f32) {label}", old_k1(lib, fwd), cc_mod.cond_chain_plain(**fwd))
        ms, cyc = read_timers(lib, len(K1_PHASES) + 5, lambda: old_k1(lib, fwd))
        whole, wgs = cyc[len(K1_PHASES)], cyc[len(K1_PHASES) + 1]
        wait, pwhole, prods = cyc[-3:]
        shares = ", ".join(f"{ph} {cyc[x] / whole:.1%}" for x, ph in enumerate(K1_PHASES))
        counted = sum(c for c, ph in zip(cyc, K1_PHASES) if ph not in PHASE_PARTS)
        say(f"timers K1 (f32) {label} (B={b} T={t}): {ms:.4f} ms a launch; per consumer "
            f"warpgroup {whole / wgs:.0f} cycles ({wgs / 5:.0f} warpgroups a launch): {shares}, "
            f"other {1 - counted / whole:.1%}; producer "
            f"{pwhole / prods:.0f} cycles, waits on empty {wait / pwhole:.1%} [{card}]")
        del fwd
        torch.cuda.empty_cache()


def phase_timers(cfg, card) -> None:
    """The kernels' phases timed by their own clock64 counters (diagnostic
    builds, ``timer_libraries``): K1 (f32) at ``k1_timer_cases``
    (``k1_f32_timers``); K1-bf16 at ``wide_shapes``' bottleneck shapes
    and the bf16 conversion's four stage shapes (each consumer warpgroup's
    cycles in h's product and lrelu, in P's products and in the epilogue);
    K2-bf16's data kernel at the batch-64 step's four stage shapes and the
    bottleneck's four and concat E = Cc = 600 (K2B_PHASES, and the
    producer's waits on empty as a share of its cycles); K2 (f32)'s data
    kernel at the f32 step's four stage shapes (K2_PHASES); with each K2
    call, its weight-grad kernel's phases (``k2_w1_timers``). Per shape: the
    shares of the warpgroups' cycles and the launch's time. Each launch is
    held to its plain version first."""
    with tempfile.TemporaryDirectory() as tmp:
        libs = timer_libraries(Path(tmp))
        k1_f32_timers(cfg, card, libs["fwd"])
        lib = libs["fwd_bf16"]
        shapes = [(label, b, t, cc, two_c, n) for label, b, t, cc, two_c, n in wide_shapes(cfg)
                  if n == 1]
        bottleneck = list(shapes)
        shapes += [(f"convert stage {k} C={c}", B, t, None, 2 * c, None)
                   for k, (t, c) in enumerate(stage_shapes(UTT, cfg))]
        for k, (label, b, t, cc, two_c, n) in enumerate(shapes):
            if cc is None:
                fwd, _, _, _ = chain_inputs(b, t, two_c // 2, cfg, seed=3400 + k,
                                            dtype=torch.bfloat16)
            else:
                ops = wide_operands(cfg, b, t, cc, two_c, n, 3400 + k, torch.bfloat16)
                fwd = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"],
                           b1=ops["b1"], edge0=None, edge_t=None)
            ulp_parity(f"timers K1-bf16 {label}", old_k1(lib, fwd), cc_mod.cond_chain_plain(**fwd))
            ms, (h_c, p_c, e_c, whole, wgs) = read_timers(lib, 5, lambda: old_k1(lib, fwd))
            say(f"timers K1-bf16 {label} (B={b} T={t}): {ms:.4f} ms a launch; per consumer "
                f"warpgroup {whole / wgs:.0f} cycles ({wgs / 5:.0f} warpgroups a launch): h "
                f"{h_c / whole:.1%}, P {p_c / whole:.1%}, epilogue {e_c / whole:.1%}, other "
                f"{1 - (h_c + p_c + e_c) / whole:.1%} [{card}]")
            del fwd
            torch.cuda.empty_cache()
        k2_data_timers(cfg, card, libs["bwd_bf16"], torch.bfloat16,
                       bottleneck + [x for x in wide_shapes(cfg) if x[-1] != 1])
        k2_data_timers(cfg, card, libs["bwd"], torch.float32)


def k2_data_timers(cfg, card, lib, dtype, extra=()) -> None:
    """K2-bf16's (batch 64) or K2 (f32)'s (batch 16) data kernel from its timer
    build ``lib`` at the step's four stage shapes and the ``extra`` shapes
    (``wide_shapes``'): each call held to the plain version, then each consumer
    warpgroup's cycles by phase (K2B_PHASES, K2_PHASES) as shares of its
    whole, and the producer's waits on empty as a share of its cycles."""
    bf16 = dtype == torch.bfloat16
    name, phases = ("K2-bf16", K2B_PHASES) if bf16 else ("K2 (f32)", K2_PHASES)
    w1_phases = K2B_W1_PHASES if bf16 else K2_W1_PHASES
    n_data = len(phases) + 5
    n_w1 = sum(len(x) + 2 for _, x in w1_phases)
    bsz, seed = (B64, 3500) if bf16 else (B, 3600)
    cases = [(f"step stage {k} C={c}", bsz, t, None, 2 * c, None)
             for k, (t, c) in enumerate(stage_shapes(SEG, cfg))]
    for k, (label, b, t, cc, two_c, n) in enumerate([*cases, *extra]):
        if cc is None:
            split, _, _, _ = chain_inputs(b, t, two_c // 2, cfg, seed=seed + k, exact_h=True,
                                          dtype=dtype)
            args = {key: v for key, v in split.items() if key != "b1"}
            g = cotangent(split, seed=seed + 50 + k).to(dtype)
        else:
            ops = wide_operands(cfg, b, t, cc, two_c, n, seed + k, dtype)
            args = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"],
                        edge0=None, edge_t=None)
            g = ops["g"]
        got, want = old_k2(lib, args, g), cc_mod.cond_chain_bwd_plain(g=g, **args)
        for key in want:
            if bf16:
                ulp_parity(f"timers {name} {label} d{key}", got[key], want[key])
            else:
                ab_f32_agree(f"timers {name} {label} d{key}", got[key], want[key])
        del got, want
        ms, cyc = read_timers(lib, n_data + n_w1, lambda: old_k2(lib, args, g))
        k2_w1_timers(name, w1_phases, label, b, t, cyc[n_data:], card)
        cyc = cyc[:n_data]
        whole, wgs = cyc[len(phases)], cyc[len(phases) + 1]
        wait, pwhole, prods = cyc[-3:]
        shares = ", ".join(f"{ph} {cyc[x] / whole:.1%}" for x, ph in enumerate(phases))
        counted = sum(c for c, ph in zip(cyc, phases) if ph not in PHASE_PARTS)
        say(f"timers {name} data kernel {label} (B={b} T={t}): {ms:.4f} ms a call; per "
            f"consumer warpgroup {whole / wgs:.0f} cycles ({wgs / 5:.0f} warpgroups a launch): "
            f"{shares}, other {1 - counted / whole:.1%}; producer {pwhole / prods:.0f} cycles, "
            f"waits on empty {wait / pwhole:.1%} [{card}]")
        del args, g
        torch.cuda.empty_cache()


def k2_w1_timers(name, phases, label, b, t, cyc, card) -> None:
    """The weight-grad kernel's line of ``--timers`` (k2b_w1_kernel,
    k2_w1_kernel) from its counters of one timed call: for each role's
    warpgroup (thread), its cycles and the shares of its phases
    (``phases``: K2B_W1_PHASES, K2_W1_PHASES)."""
    parts, k = [], 0
    for role, names in phases:
        c = cyc[k:k + len(names)]
        whole, wgs = cyc[k + len(names)], cyc[k + len(names) + 1]
        k += len(names) + 2
        shares = ", ".join(f"{ph} {x / whole:.1%}" for ph, x in zip(names, c))
        parts.append(f"per {role} {whole / wgs:.0f} cycles ({wgs / 5:.0f} a launch): "
                     f"{shares}, other {1 - sum(c) / whole:.1%}")
    say(f"timers {name} w1 kernel {label} (B={b} T={t}): {'; '.join(parts)} [{card}]")


KERNEL_NAME = (r"(k1_f32_kernel|k1_images_kernel|cond_chain_fwd_kernel|k1_bf16_kernel|"
               r"w_images_kernel|k2b?_\w+?_kernel)((?:I(?:L[ib]\d+E)+E)?)")


def ptxas_summary(log: str) -> list[str]:
    """'kernel: registers, spills' for every kernel in nvcc's -Xptxas -v
    output, then 'kernel: C75xx <reason>' for every kernel whose wgmma ptxas
    serializes (its warnings C7510-C7520 that say so; the line as ptxas gives
    it where it names no kernel)."""
    out, warns, name = [], [], None

    def kernel(m) -> str:
        targs = re.findall(r"L[ib](\d+)E", m.group(2))
        return m.group(1) + (f"<{','.join(targs)}>" if targs else "")

    for ln in log.splitlines():
        code = re.search(r"\((C75\d\d)\)", ln)
        if code and "serialized" in ln:
            w = re.search(r"\(C75\d\d\)\s*(.*?)\s*in the function '.*?" + KERNEL_NAME, ln)
            warns.append(f"{kernel(re.search(KERNEL_NAME, w.group(0)))}: {code.group(1)} "
                         f"{w.group(1)}" if w else ln.strip()[:300])
            continue
        if code:  # ptxas's notes that it added a warpgroup.arrive: not a loss
            continue
        m = re.search(r"Compiling entry function '.*?" + KERNEL_NAME, ln)
        if m:
            name = kernel(m)
        elif name and "spill" in ln:
            out.append(f"{name}: {ln.strip()}")
        elif name and "registers" in ln:
            out[-1] += f", {ln.split(':', 1)[1].strip()}"
            name = None
    return out + warns


def say_earlier(rows):
    """Each kernel's time in this run beside its EARLIER_MS entries."""
    for row in rows:
        for path, ms, per, version in EARLIER_MS[row["name"]]:
            now = row["ms"] if path is None else row["by_path"][path]["ms"]
            say(f"earlier: {row['name']} {now:.3f} ms per {per} in this run "
                f"({now / ms - 1:+.2%}); {ms:.3f} ms recorded in PERF.md for the "
                f"kernels {version} (not measured here)")


class _Lines:
    """``sys.stdout`` while phases run: each whole line goes to the real
    stdout in one write (the CLI lanes print from several threads at once),
    and every line a thread prints is copied to the buffers of the phases
    open in that thread (``Phases.run``'s)."""

    def __init__(self, out):
        self.out, self.lock, self.local = out, threading.Lock(), threading.local()

    def buffers(self) -> list:
        if not hasattr(self.local, "buffers"):
            self.local.buffers, self.local.part = [], ""
        return self.local.buffers

    def write(self, text):
        for buf in self.buffers():
            buf.write(text)
        self.local.part += text
        if "\n" in self.local.part:
            whole, self.local.part = self.local.part.rsplit("\n", 1)
            with self.lock:
                self.out.write(whole + "\n")
                self.out.flush()
        return len(text)

    def flush(self):
        with self.lock:
            self.out.flush()

    def __getattr__(self, name):
        return getattr(self.out, name)


# Each phase's headline in the summary: (name, pattern with one group, how the
# matches are shown: "first", "all", or "max" of the numbers).
HEADLINES = {
    "2 build": [("nvcc", r"in ([\d.]+ s);", "first")],
    "3 K1 parity": [("worst of max|ref|", r"max\|d\|=[\d.e+-]+ \(([\d.e+-]+)", "max"),
                    ("K1 at the CLIs' shapes, worst max|d|",
                     r"worst max\|d\| ([\d.e+-]+); tolerance", "first")],
    "4 convert": [("ms per call", r"convert_tensors ([\d.]+) ms per call", "first"),
                  ("RTF", r"RTF ([\d.]+x)", "first")],
    "5 K1 times": [("K1 ms per convert call", r"k1 per convert call \(4 calls\): ([\d.]+) ms",
                    "first"),
                   ("per train step", r"k1 per train step \(8 calls\): ([\d.]+) ms", "first")],
    "6 K2 parity, wide and tiled": [("worst of max|ref|",
                                     r"(?:split|concat)\.\w+ ([\d.e+-]+)", "max")],
    "7 train": [("ms per step", r"median ([\d.]+) ms per step", "first"),
                ("peak GiB", r"peak device memory ([\d.]+) GiB", "first")],
    "8 K2 times": [("K2 ms per step", r"k2 per train step \(8 calls\): ([\d.]+) ms", "first"),
                   ("K2 by kernel per step",
                    r"k2 kernels per train step \(8 calls\): (.*?) \[", "first")],
    "9 train CLI": [("loop ms per step", r"median of steps 1-4: ([\d.]+) ms", "first")],
    "10 generate CLI": [("RTF in the CLI", r"\(RTF ([\d.]+x), pitch", "first")],
    "11 wavlm convert": [("ms per call", r"convert_tensors ([\d.]+) ms per call", "first"),
                         ("RTF", r"RTF ([\d.]+x)", "first")],
    "12 wavlm train": [("ms per step", r"median ([\d.]+) ms per step", "first"),
                       ("peak GiB", r"peak device memory ([\d.]+) GiB", "first")],
    "13 wavlm CLIs": [("loop ms per step", r"median of steps 1-4 ([\d.]+) ms", "first")],
    "14 bf16 kernels": [("K1-bf16 ms per convert call",
                         r"k1-bf16 per bf16 convert call \(4 calls\): ([\d.]+) ms", "first"),
                        ("K2-bf16 ms per b64 step",
                         r"k2-bf16 per batch-64 train step \(8 calls\): ([\d.]+) ms", "first"),
                        ("K2-bf16 by kernel per b64 step",
                         r"k2-bf16 kernels per batch-64 train step \(8 calls\): (.*?) \[", "first")],
    "15 bf16 convert": [("ms per call (conv, wavlm)",
                         r"bf16 convert \(\w+\):.*?convert_tensors ([\d.]+) ms", "all"),
                        ("SNR dB", r"SNR ([\d.]+) dB", "all"),
                        ("max|d| vs the plain chain (conv, wavlm)",
                         r"plain-bf16-chain path max\|d\| ([\d.e+-]+)", "all")],
    "16 bf16 train": [("ms per b64 step (wavlm, conv)", r"steps: median ([\d.]+) ms", "all")],
    "17 bf16 CLIs": [("loop ms per step", r"loop step median of steps 1-4 ([\d.]+) ms", "first")],
    "18 stage steps": [("ms per step (S1, S21, W1)", r"median ([\d.]+) ms per step", "all")],
    "19 curriculum CLIs": [],
    "20 evaluation": [("ECAPA ms per utterance", r"([\d.]+) ms per utterance on the card",
                       "first"),
                      ("run_test process s", r"([\d.]+) s of wall time for the process",
                       "first")],
    "21 data parallel": [("one-rank ms per step", r"one rank, no group: step median ([\d.]+) ms",
                          "first")],
    "22 options": [("convert ms per call",
                    r"options convert: convert_tensors ([\d.]+) ms", "first"),
                   ("ms per step", r"median ([\d.]+) ms per step", "first"),
                   ("bf16 convert ms",
                    r"options bf16 convert \(conv\):.*?convert_tensors ([\d.]+) ms", "first"),
                   ("bf16 SNR dB", r"SNR ([\d.]+) dB", "first")],
}


class Phases:
    """Each phase's wall time and headline numbers, read from what it
    prints (a tee of stdout), for the summary printed before the kernel
    table: one line a phase, so that the end of the output, all that may
    come back from a run, holds every phase's numbers."""

    def __init__(self):
        self.rows: list[tuple[str, float, float, str]] = []
        self.text: dict[str, str] = {}
        if not isinstance(sys.stdout, _Lines):
            sys.stdout = _Lines(sys.stdout)

    def run(self, label: str, fn, *args, **kw):
        buf, open_ = io.StringIO(), sys.stdout.buffers()
        open_.append(buf)
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kw)
        finally:
            open_.remove(buf)
        self.text[label] = buf.getvalue()
        self.rows.append((label, t0, time.perf_counter(), self.headline(label)))
        return out

    def headline(self, label: str) -> str:
        parts = []
        for name, pattern, how in HEADLINES[label]:
            found = re.findall(pattern, self.text[label])
            if not found:
                parts.append(f"{name} not printed")
            elif how == "max":
                parts.append(f"{name} {max(float(x) for x in found):.2e}")
            else:
                parts.append(f"{name} {found[0] if how == 'first' else ', '.join(found)}")
        return "; ".join(parts)

    def say_summary(self, card: str):
        rows = sorted(self.rows, key=lambda r: int(r[0].split()[0]))
        for label, t0, t1, head in rows:
            say(f"summary: phase {label}: {t1 - t0:.1f} s" + (f"; {head}" if head else ""))
        say(f"summary: phases {sum(t1 - t0 for _, t0, t1, _ in rows):.1f} s in all, "
            f"{max(r[2] for r in rows) - min(r[1] for r in rows):.1f} s of wall time (the "
            f"lanes of phases {LANES} overlap) [{card}]")


def main(ab_dir: Path | None = None, timers: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device 0 {torch.cuda.get_device_name(0)} of {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = Phases()

    def build():
        _, build_s, log = cc_mod.build()
        names = [" + ".join(x.name for x in cc_mod._sources_of(src))
                 for src in cc_mod.SOURCES + cc_mod.BF16_SOURCES]
        say(f"build: {', '.join(names)} with nvcc, in parallel, in {build_s:.1f} s; "
            + " | ".join(ptxas_summary(log)))

    phases.run("2 build", build)
    cfg = Config()
    if timers:
        phase_timers(cfg, card)
    if ab_dir is not None:
        say(json.dumps({"ab": phase_ab(cfg, card, ab_dir), "card": card}))
    if timers or ab_dir is not None:
        return 0
    run = phases.run
    with tempfile.TemporaryDirectory() as tmp:
        root = write_corpus(Path(tmp))
        parity_err = run("3 K1 parity",
                         lambda: max(phase_parity(cfg), cli_chain_parity(cfg, root, card)))
        convert_launches, convert_ms = run("4 convert", phase_slice, cfg, card)
        k1_row = run("5 K1 times", phase_kernel_times, cfg, card, convert_launches, parity_err)
        k2_err = run("6 K2 parity, wide and tiled",
                     lambda: (phase_k2_parity(cfg), wide_parity(cfg, card))[0])

        def train():
            out = phase_step("train", cfg, card, STAGES * 2)
            pipeline_beside_step(cfg, root, card)
            return out

        (train_k1, train_k2), bare_median = run("7 train", train)
        k2_row = run("8 K2 times", phase_k2_times, cfg, card, train_k2, k2_err)
        wavlm_convert_k1 = run("11 wavlm convert", phase_wavlm_convert, cfg, card)
        (wavlm_train_k1, wavlm_train_k2), _ = run("12 wavlm train", phase_step, "wavlm train",
                                                  wavlm_cfg(cfg), card, STAGES * 2)
        k1b_row, k2b_row = run("14 bf16 kernels", phase_bf16_kernels, cfg, card)
        bf16_convert_k1 = run("15 bf16 convert", phase_bf16_convert, cfg, card)
        bf16_train_k1, bf16_train_k2 = run("16 bf16 train", phase_bf16_train, cfg, card)

        # no cycle pass at these stages: one decode (at 2B, or at B under
        # no_conv), so one K1 and one K2 launch per decoder stage
        def stage_steps():
            out = []
            for name, overrides in (("S1", STAGE_S1), ("S21", STAGE_S21), ("W1", STAGE_W1)):
                say(f"stage {name}: {' '.join(o.split('.', 1)[1] for o in overrides)}")
                out.append(phase_step(f"stage {name}", stage_cfg(overrides), card, STAGES)[0])
            return out

        stage_k = run("18 stage steps", stage_steps)
        options = run("22 options", phase_options, card, convert_ms, bare_median)
        # The CLI phases and data parallelism last, as five lanes at once:
        # they spend most of their time starting processes, and no other
        # lane launches a kernel in this process while phase 21 counts its
        # launches (every CLI counts its own in its process)
        lanes = {
            "cli": lambda: (run("9 train CLI", phase_train_cli, root, card, bare_median),
                            run("10 generate CLI", phase_generate_cli, root, card)),
            "wavlm": lambda: run("13 wavlm CLIs", phase_wavlm_clis, root, card),
            "bf16": lambda: run("17 bf16 CLIs", phase_bf16_clis, root, card),
            "curriculum": lambda: (run("19 curriculum CLIs", phase_curriculum_clis, root, card),
                                   run("20 evaluation", phase_eval, root, card)),
            "dp": lambda: run("21 data parallel", phase_data_parallel, cfg, root, card)}
        with ThreadPoolExecutor(len(lanes)) as pool:
            done = {name: pool.submit(fn) for name, fn in lanes.items()}
        done = {name: fut.result() for name, fut in done.items()}
        (cli_k1, cli_k2), gen_k1 = done["cli"]
        wavlm_cli_k1, wavlm_cli_k2, wavlm_gen_k1 = done["wavlm"]
        bf16_cli_k1, bf16_cli_k2, bf16_gen_k1 = done["bf16"]
        (cur_k1, cur_k2, cur_gen_k1), eval_k1 = done["curriculum"]
        dp = done["dp"]
    opt = options["launches"]
    # K1 runs on every main path: conversion (phases 4, 11 and 22), the train
    # step (phases 7, 12, 18 and 22) and the CLIs (phases 9, 10, 13 and 19); K2
    # on the training paths
    k1_row["launches_by_path"] = {"convert": convert_launches, "train": train_k1,
                                  "train_cli": cli_k1, "generate_cli": gen_k1,
                                  "wavlm_convert": wavlm_convert_k1,
                                  "wavlm_train": wavlm_train_k1, "wavlm_train_cli": wavlm_cli_k1,
                                  "wavlm_generate_cli": wavlm_gen_k1,
                                  "stage_train": sum(k[0] for k in stage_k),
                                  "curriculum_train_cli": cur_k1,
                                  "curriculum_generate_clis": cur_gen_k1,
                                  "eval_cli": eval_k1,
                                  "data_parallel_train": dp["train"][0],
                                  "sharded_convert": dp["convert"],
                                  "options_convert": opt["options_convert"],
                                  "options_train": opt["options_train"][0]}
    k1_row["launches"] = sum(k1_row["launches_by_path"].values())
    k2_row["launches_by_path"] = {"train": train_k2, "train_cli": cli_k2,
                                  "wavlm_train": wavlm_train_k2, "wavlm_train_cli": wavlm_cli_k2,
                                  "stage_train": sum(k[1] for k in stage_k),
                                  "curriculum_train_cli": cur_k2,
                                  "data_parallel_train": dp["train"][1],
                                  "options_train": opt["options_train"][1]}
    k2_row["launches"] = sum(k2_row["launches_by_path"].values())
    # the bf16 instances on the bf16 paths: conversion (phases 15 and 22),
    # the batch-64 train step (phase 16, both encoders), the CLIs (phase 17)
    k1b_row["launches_by_path"] = {"convert": bf16_convert_k1, "train": bf16_train_k1,
                                   "train_cli": bf16_cli_k1, "generate_cli": bf16_gen_k1,
                                   "options_bf16_convert": opt["options_bf16_convert"]}
    k1b_row["launches"] = sum(k1b_row["launches_by_path"].values())
    k2b_row["launches_by_path"] = {"train": bf16_train_k2, "train_cli": bf16_cli_k2}
    k2b_row["launches"] = sum(k2b_row["launches_by_path"].values())
    # the bottleneck's shapes (phase 22), each kernel's numbers by shape
    for row, name in ((k1_row, "cond_chain_fwd"), (k2_row, "cond_chain_bwd"),
                      (k1b_row, "cond_chain_fwd_bf16"), (k2b_row, "cond_chain_bwd_bf16")):
        row["max_abs_err"] = max(row["max_abs_err"], *(
            v["max_abs_err"] for v in options["bottleneck"][name].values()))
        row["bottleneck"] = {shape: {k: v[k] for k in ("ms", "c_entry_ms", "plain_ms",
                                                        "bound_ms", "library_ms")}
                             for shape, v in options["bottleneck"][name].items()}
    say_earlier([k1_row, k2_row, k1b_row, k2b_row])
    phases.say_summary(card)
    say(f"total {time.perf_counter() - t_start:.1f} s [{card}]")
    say(json.dumps({"kernels": [k1_row, k2_row, k1b_row, k2b_row]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts, so that
    what a CLI's process leaves behind becomes this one's child, for
    ``end_children`` to end and reap (Linux's PR_SET_CHILD_SUBREAPER)."""
    if ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def child_pids() -> list[int]:
    """The processes whose parent is this one, zombies included (from /proc)."""
    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except (OSError, ValueError):
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(entry))
    return out


def end_children(grace_s: float = 10.0) -> None:
    """End every process this one still has: multiprocessing's resource
    tracker (which ignores SIGTERM; stopped the way multiprocessing stops
    it), then any other child, with SIGTERM and, after ``grace_s``, SIGKILL;
    each is reaped."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # a semaphore freed later would start a new tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    deadline = time.monotonic() + grace_s
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in child_pids():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        while (pids := child_pids()) and time.monotonic() < deadline:
            for pid in pids:
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
            time.sleep(0.05)
        deadline = time.monotonic() + grace_s
    if child_pids():
        raise RuntimeError(f"processes {child_pids()} outlived SIGKILL")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ab", type=Path, default=None, metavar="DIR",
                        help="only the A/B of the kernels against earlier sources in DIR")
    parser.add_argument("--timers", action="store_true",
                        help="only the kernels' phases timed by their clock64 counters "
                             "(diagnostic builds)")
    cli = parser.parse_args()
    adopt_orphans()
    try:
        rc = main(cli.ab, cli.timers)
    finally:
        end_children()
    sys.exit(rc)
