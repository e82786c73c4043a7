#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card (Hopper:
the kernel is built for sm_90a) and the CUDA toolkit. It needs no network
and no weights: everything is made from seeds. Phases, one line or more each:

1. card: name and power limit (nvidia-smi) and torch's device name;
2. build: nvcc compiles both kernel sources (K1, the FiLM cond chain's
   forward; K2, its backward; both on the tensor cores as 3xTF32 through
   csrc/tf32x3.cuh), one nvcc per source, started together;
3. parity: K1 against its plain PyTorch version at the four decoder-stage
   shapes of an 8960-sample segment (B=2), split and concat forms;
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
   K2 at widths off the decoder's defaults (Cc = 264; E = 6 and 10), at
   every stage's shape for the widths whose shared memory needs the smaller
   time tiles (split Cc = 392 and 1204, concat Cc = 184 and 344), and
   their refusal of a width no tile holds (concat Cc = 704);
7. train: the full-width stage-2 GAN train step (D -> C -> G, the config
   defaults, conv encoder) on 16 x 8960 samples: its first step against the
   same step with the plain chain, then a warm-up and timed steps (CUDA
   events) with 8 K1 and 8 K2 launches counted in each, loss and parameter
   checks, peak memory, and one step's device time by kernel;
8. K2 at the step's eight (stage, batch) shapes: against its plain
   version, a second run bit for bit, then its time beside the two bounds,
   the plain version and cuDNN's backward of the same chain (a yardstick);
9. the train CLI (``python -m td_vc_gan_tpu_torch.cli.train``, a
   subprocess) on a corpus the script writes (16 speakers x 6 utterances of
   1.5-4 s, 4 of them FLAC): epochs 0 and 1 (10 steps at batch 16, through
   the data pipeline with its corruption), validation, checkpoints and
   sample dumps at every epoch, then a resume for 2 more steps; checks on
   the losses, the kernel launches of every step, the resumed state, the
   reference-format export and the samples; the loop's step time beside
   phase 7's, its wait on the input pipeline, the host's corruption time per
   batch, checkpoint seconds and bytes, peak device memory; then the bare
   step with the next batch made beside it by threads (8; 8 with a longer
   switch interval; 1) and by the package's worker processes;
10. the conversion CLI (``python -m td_vc_gan_tpu_torch.cli.generate_with_target``,
   a subprocess) on that run: 4 test utterances to each of the 4 speakers
   of the test manifest, file and log checks, K1 launches per convert_batch
   call, wall time and RTF; then K1 against its plain version at the chain
   shapes of the two CLIs (B=1 at each test utterance's validation and
   sample bucket, B=4 at its conversion bucket, every stage).

Float32 throughout, with TF32 off in cuDNN and matmul (the CLIs set the
same): the port's compute type is f32, as the JAX package's default. Any failed check raises, and the
script then exits non-zero without its result lines. The last two lines are
the JSON kernel table (this run's numbers only) and the result object;
before them, each kernel's time beside the one recorded for its previous
version in PERF.md. The script is the subreaper of every process it starts
(the CLIs and what they start, the data pipeline's workers, ``nvcc``) and,
pass or fail, ends and reaps each of them before it exits.
"""

from __future__ import annotations

import copy
import ctypes
import gc
import inspect
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from td_vc_gan_tpu_torch.config import Config, load_config
from td_vc_gan_tpu_torch.data import corruption
from td_vc_gan_tpu_torch.data.audio_io import read_audio, write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset, collate, make_train_iterator
from td_vc_gan_tpu_torch.data.flac import write_flac
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import crepe_from_seed
from td_vc_gan_tpu_torch.models.discriminator import discriminator_from_config
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.models.layers import MRFBlock, init_weights
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cc_mod
from td_vc_gan_tpu_torch.testing import PARITY_RTOL, chain_inputs, dyadic, stage_shapes
from td_vc_gan_tpu_torch.training import checkpoint as ckpt
from td_vc_gan_tpu_torch.training.loop import _pad_bucket
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
# conditional_dim, E): a wider speaker embedding (Cc = 264: two passes of
# K2's da product, two column groups of the h recompute); excitation widths
# that are not a multiple of 4 (K2's dW0 stages exc in 4-byte pieces, in
# either weight-grad tile: E <= 8 and E > 8). Held at one stage's shape.
WIDE_CASES = (("split", 256, 8), ("split", 130, 6), ("split", 126, 10))
# The widths whose 128-row plans pass a block's shared memory, so that both
# kernels take 64-row tiles (split Cc = 392, concat Cc = 184) or 32-row tiles
# (concat Cc = 344; split Cc = 1204, where K2's 32-row tile runs its da
# product in 10 passes), held at all four stages' shapes (2C = 256 down to
# 32, partial last tiles); and one width that no tile holds (concat Cc = 704),
# which the kernels refuse.
TILED_CASES = (("split", 384, 8), ("concat", 176, 8), ("concat", 336, 8),
               ("split", 1196, 8))
REFUSED_CASE = ("concat", 696, 8)
# The kernels' times before they took smaller time tiles at wide Cc (one
# fixed 128-row tile), as recorded in PERF.md section 6 (NVIDIA H100 80GB
# HBM3, 700 W). Printed beside this run's on a line of their own, never in
# the JSON kernel table, which holds only this run's numbers.
EARLIER_MS = {"cond_chain_fwd": (25.500, "convert call"),
              "cond_chain_bwd": (38.872, "train step")}
# The CLI phases' corpus: speakers x utterances of 1.5-4 s; the first
# TRAIN_UTT of each speaker train (80 files: 5 steps an epoch at batch 16),
# the last of TEST_SPK speakers convert; FLAC_FILES are written as FLAC.
CORPUS_SPK, CORPUS_UTT, TRAIN_UTT = 16, 6, 5
TEST_SPK = (0, 5, 10, 15)
FLAC_FILES = ((0, 1), (5, 2), (10, 3), (15, 4))
CLI_OVERRIDES = ("model.generator.encoder_model=conv", "train.num_epoch=1",
                 "log.log_interval=1", "log.save_interval=1", "log.val_interval=1",
                 "log.gen_interval=1", "log.gen_num=2", "test.num_tests=2")
CLI_TIMEOUT = 300


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


def chain_args(cfg, form: str, s: int, e: int, stage: int, seed: int):
    """Dyadic operands of one chain at conditional_dim ``s`` and E = ``e``
    (B=2, one training stage's T and C): (K1's kwargs, K2's kwargs without
    g, the split-form kwargs, n, Cc)."""
    t, c = stage_shapes(SEG, cfg)[stage]
    wcfg = copy.deepcopy(cfg)
    wcfg.model.generator.conditional_dim = s
    split, concat, n, cc = chain_inputs(2, t, c, wcfg, seed=seed, exact_h=True, e=e)
    if form == "split":
        fwd_args = split
        bwd_args = {k: v for k, v in split.items() if k != "b1"}
    else:
        fwd_args = dict(exc=concat["c"], w0=concat["w0"], hbias=concat["b0"],
                        w1=concat["w1"], b1=concat["b1"])
        bwd_args = {k: v for k, v in fwd_args.items() if k != "b1"}
        bwd_args.update(edge0=None, edge_t=None)
    return fwd_args, bwd_args, split, n, cc


def wide_case(cfg, form: str, s: int, e: int, stage: int, timed: bool):
    """K1 and K2 against their plain versions at one width and stage, with
    the tiles the libraries take; with ``timed``, each kernel's time beside
    the 3xTF32 bound of its operations. One part of the wide-parity line."""
    t, c = stage_shapes(SEG, cfg)[stage]
    fwd_lib, bwd_lib = cc_mod._library()
    fwd_args, bwd_args, split, n, cc = chain_args(cfg, form, s, e, stage, 900 + e + s + stage)
    ew = fwd_args["exc"].shape[-1]
    tiles = (fwd_lib.cond_chain_fwd_tile(ew, cc, 2 * c),
             bwd_lib.cond_chain_bwd_rows(2, t, ew, n, cc, 2 * c))
    _, r_fwd = rel_err(cc_mod.cond_chain(**fwd_args), cc_mod.cond_chain_plain(**fwd_args))
    g = cotangent(split, seed=950 + e + s + stage)
    got = cc_mod._launch_bwd(g=g, **bwd_args)
    want = cc_mod.cond_chain_bwd_plain(g=g, **bwd_args)
    r_bwd = max(rel_err(got[k], want[k])[1] for k in want)
    torch.cuda.synchronize()
    part = (f"{form} Cc={cc} E={ew} T={t} 2C={2 * c} (K1 tile {tiles[0]}, K2 rows "
            f"{tiles[1]}): K1 {r_fwd:.1e}, K2 (worst output) {r_bwd:.1e}")
    if timed:
        k1_ms = cuda_ms(lambda: cc_mod.cond_chain(**fwd_args), iters=5, warmup=1)
        k2_ms = cuda_ms(lambda: cc_mod._launch_bwd(g=g, **bwd_args), iters=5, warmup=1)
        k1_bound = bounds(2.0 * 2 * t * (n * cc * 3 * ew + n * 2 * c * 3 * cc), 0)[0]
        k2_bound = bounds(k2_work(2, t, ew, n, cc, 2 * c)[0], 0)[0]
        part += (f"; K1 {k1_ms:.3f} ms (bound {k1_bound:.3f}), K2 {k2_ms:.3f} ms "
                 f"(bound {k2_bound:.3f})")
    if not (r_fwd <= PARITY_RTOL and r_bwd <= PARITY_RTOL):
        raise AssertionError(f"cond-chain kernels disagree with their plain versions at "
                             f"{form} Cc={cc} E={ew} T={t}")
    del fwd_args, bwd_args, split, g, got, want
    torch.cuda.empty_cache()
    return part


def wide_parity(cfg, card, stage: int = 1):
    """K1 and K2 against their plain versions (B=2, dyadic cond_0 operands)
    at WIDE_CASES on one training stage's (T, C), and at TILED_CASES on all
    four stages', each with the tiles its library takes; each case timed at
    ``stage``; then the kernels' refusal of REFUSED_CASE."""
    for form, s, e in WIDE_CASES:
        say("wide parity: " + wide_case(cfg, form, s, e, stage, timed=True)
            + f"; tolerance {PARITY_RTOL:.0e} of max|ref| [{card}]")
    for form, s, e in TILED_CASES:
        parts = [wide_case(cfg, form, s, e, i, timed=i == stage) for i in range(STAGES)]
        say("tiled parity: " + "; ".join(parts)
            + f"; tolerance {PARITY_RTOL:.0e} of max|ref| [{card}]")
    form, s, e = REFUSED_CASE
    fwd_args, bwd_args, split, _, cc = chain_args(cfg, form, s, e, stage, seed=990)
    g = cotangent(split, seed=991)
    for name, call in (("K1", lambda: cc_mod.cond_chain(**fwd_args)),
                       ("K2", lambda: cc_mod._launch_bwd(g=g, **bwd_args))):
        try:
            call()
        except ValueError as err:
            if "shared memory" not in str(err):
                raise
        else:
            raise AssertionError(f"{name} took {form} Cc={cc}, which no time tile holds")
    say(f"refused: {form} Cc={cc} E={cc}: K1 and K2 raise before any launch (no time tile's "
        f"shared memory fits a block's 227 KB)")


def signals(seed: int, n: int = UTT) -> np.ndarray:
    """B voiced-like utterances of n samples: a gliding harmonic tone per row
    plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = rng.uniform(90, 260, (B, 1)) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 16000
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    return (0.2 * x + 0.01 * rng.standard_normal((B, n))).astype(np.float32)


def phase_slice(cfg, card):
    t0 = time.perf_counter()
    g = generator_from_config(cfg.model.generator, num_classes=100, seed=0)
    conv = Converter(cfg, g, crepe_from_seed(1), decoder="viterbi")
    sigs = signals(0)
    labels = np.arange(B) % 100
    say(f"slice: full-width conv-encoder G ({sum(p.numel() for p in g.parameters())} "
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
    say(f"slice: pitch_batch {pitch_s:.2f} s (first call), convert_batch {convert_s:.2f} s "
        f"(first call); voiced frames {float((f0 > 0).mean()):.3f}; cond-chain kernel "
        f"launches in pitch_batch + convert_batch: {launches}")
    if launches != len(cfg.model.generator.decoder_ratios):
        raise AssertionError(f"expected one cond-chain launch per decoder stage, got {launches}")
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
    say(f"slice: kernel path vs plain-chain path max|d|={d_plain:.3e} (tolerance {AUDIO_ATOL})")
    if d_plain > AUDIO_ATOL:
        raise AssertionError("the kernel path and the plain path disagree")

    # a small input against the CPU path (which the tests hold against JAX)
    cpu = Converter(cfg, generator_from_config(cfg.model.generator, 100, device="cpu", seed=0),
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
    say(f"slice: small input (1 x {SEG}) card vs CPU: audio max|d|={d_cpu:.3e} "
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
    say(f"slice: convert_tensors {ms:.2f} ms per call for {B} x {UTT} samples "
        f"({audio_s:.1f} s of audio): conversion RTF {audio_s / (ms / 1e3):.1f}x real time; "
        f"pitch_tensors (Viterbi) {pitch_ms:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    profile_call(lambda: conv.convert_tensors(*args, lab, seed=1), "one convert call", card)
    return launches


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
        return
    say(f"profile: {label} {wall_ms:.2f} ms wall (profiler on), kernels busy "
        f"{busy:.2f} ms ({busy / wall_ms:.1%}), {sum(v[1] for v in by_name.values())} "
        f"kernel launches [{card}]")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"profile: {ms:8.3f} ms {ms / busy:6.1%} x{count:<5d} {name[:90]}")


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
        f"max|d| vs plain {d:.2e} [{card}]")
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
    """The full-width stage-2 models (random weights from seeds) and their
    optimizers."""
    g = generator_from_config(cfg.model.generator, NUM_SPK, seed=0)
    d = discriminator_from_config(cfg, NUM_SPK, seed=1)
    return create_train_state(cfg, g, d, None, crepe_from_seed(2).cuda())


def phase_train(cfg, card):
    """The full-width stage-2 GAN train step: its first step against the
    same step with the plain chain, then timed steps with the launch counts
    of each, and one step's kernels by device time."""
    t0 = time.perf_counter()
    state = train_state(cfg)
    step = build_train_step(cfg, state)
    batch = train_batch(10)
    n_g = sum(p.numel() for p in state.G.parameters())
    n_d = sum(p.numel() for p in state.D.parameters())
    before = {f"G.{k}": v.clone() for k, v in state.G.state_dict().items()}
    before.update({f"D.{k}": v.clone() for k, v in state.D.state_dict().items()})
    say(f"train: G {n_g} and D {n_d} parameters, batch {B} x {SEG}, "
        f"set up in {time.perf_counter() - t0:.1f} s")

    # the first step, with the kernels and with the plain chain swapped in
    m_kernel = step(batch, torch.Generator(device="cuda").manual_seed(5))
    twin = train_state(cfg)
    twin_step = build_train_step(cfg, twin)
    kernel_op = cc_mod.cond_chain
    cc_mod.cond_chain = cc_mod.cond_chain_plain
    try:
        m_plain = twin_step(batch, torch.Generator(device="cuda").manual_seed(5))
    finally:
        cc_mod.cond_chain = kernel_op
    worst_loss = max(abs(float(m_kernel[k]) - float(m_plain[k])) /
                     max(abs(float(m_plain[k])), 1e-6) for k in m_plain)
    worst_mu = 0.0
    for net, twin_net, opt, twin_opt in ((state.G, twin.G, state.opt_g, twin.opt_g),
                                         (state.D, twin.D, state.opt_d, twin.opt_d)):
        for p, q in zip(net.parameters(), twin_net.parameters()):
            a = opt.optimizer.state[p]["exp_avg"]
            b = twin_opt.optimizer.state[q]["exp_avg"]
            worst_mu = max(worst_mu, float((a - b).abs().max()) /
                           max(float(b.abs().max()), 1e-30))
    say(f"train: first step, kernel path vs plain-chain path: losses worst relative "
        f"difference {worst_loss:.2e} (tolerance {STEP_LOSS_RTOL:.0e}); G and D first "
        f"moments worst max|d| {worst_mu:.2e} of the tensor's max|ref| "
        f"(tolerance {STEP_MU_RTOL:.0e})")
    if not (worst_loss <= STEP_LOSS_RTOL and worst_mu <= STEP_MU_RTOL):
        raise AssertionError("the train step with the kernels disagrees with the plain chain")
    del twin, twin_step
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(6)
    step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], []
    cc_mod.launches = cc_mod.bwd_launches = 0
    for _ in range(TRAIN_STEPS):
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
        raise AssertionError(f"non-finite losses after {TRAIN_STEPS + 2} steps: {bad}")
    if any(c != (STAGES * 2, STAGES * 2) for c in counts):
        raise AssertionError(f"expected {STAGES * 2} K1 and {STAGES * 2} K2 launches per "
                             f"step, got {counts}")
    after = {f"G.{k}": v for k, v in state.G.state_dict().items()}
    after.update({f"D.{k}": v for k, v in state.D.state_dict().items()})
    still = [k for k, v in before.items() if torch.equal(v, after[k])]
    if still:
        raise AssertionError(f"parameters that did not change: {still[:5]}")
    median = ms[len(ms) // 2]
    say(f"train: {TRAIN_STEPS} timed steps: median {median:.2f} ms per step (min "
        f"{ms[0]:.2f}, max {ms[-1]:.2f}), {1e3 / median:.3f} steps/s, "
        f"{B * 1e3 / median:.2f} segments/s; K1/K2 launches per step {counts[0]}; "
        f"G_loss {float(metrics['G_loss']):.4f}, D_loss {float(metrics['D_loss']):.4f}; "
        f"every G and D parameter changed; peak device memory {peak:.2f} GiB [{card}]")
    profile_call(lambda: step(batch, gen), "one train step", card)
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


def phase_k2_times(cfg, card, launches, parity_err):
    """K2 at the train step's eight (stage, batch) shapes: against its plain
    version, a second run bit for bit (no atomics: the same result every
    run), then kernel, bounds, plain version and cuDNN's backward of the same
    chain."""
    totals = Totals()
    worst = parity_err
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
            flops, nbytes = k2_work(bsz, t, e, n, cc, 2 * c)
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
    say(f"k2 per train step (8 calls): {totals.line()} [{card}]")
    return {"name": "cond_chain_bwd", "route": "cuda",
            "source": "td_vc_gan_tpu_torch/csrc/cond_chain_bwd.cu",
            "replaces": "td_vc_gan_tpu/ops/pallas/cond_chain.py:221",
            "launches": launches, "max_abs_err": worst, **totals.row(),
            "bound_by": bounds(totals["flops"], totals["bytes"])[2]}


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
        "--load_path", str(run), "--max_steps", "12", "--override", "train.num_epoch=2"])
    steps = step_lines(first)
    resumed = step_lines(second)
    if [s["Itt"] for s in steps] != list(range(10)) or [s["Itt"] for s in resumed] != [10, 11]:
        raise AssertionError(f"logged steps {[s['Itt'] for s in steps]} then "
                             f"{[s['Itt'] for s in resumed]}, expected 0..9 then 10, 11")
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
        raise AssertionError("the resumed train state differs from the one saved at epoch 1")
    peaks = [float(v) for ln in one_line(first, "Saved 2 samples")
             for v in re.findall(r"(\d+\.\d+)(?:,|$)", ln.split("max|y| before writing:")[1])]
    if "not finite" in " ".join(first) or not peaks or max(peaks) > 1.0:
        raise AssertionError(f"sample dumps: max|y| {peaks}, finite "
                             f"{'not finite' not in ' '.join(first)}")
    # the reference-format export, re-imported into a fresh G
    cfg = load_config(run / "config.yaml")
    g = generator_from_config(cfg.model.generator, CORPUS_SPK, seed=123)
    ckpt.import_torch_generator(cfg, run / "step1-G.pt", g)
    blob = torch.load(run / ckpt.STATE_DIR / "epoch_1.pt", map_location="cpu",
                      weights_only=False)
    differ = [k for k, v in g.state_dict().items() if not torch.equal(v.cpu(), blob["G"][k])]
    if differ:
        raise AssertionError(f"step1-G.pt re-imported differs from the saved G: {differ[:5]}")
    done = [re.search(r"K1 (\d+) \(validation (\d+), samples (\d+)\), K2 (\d+)", ln).groups()
            for ln in (one_line(first, "Done at step")[0], one_line(second, "Done at step")[0])]
    k1 = sum(int(d[0]) for d in done)
    k2 = sum(int(d[3]) for d in done)
    loop_ms = sorted(s["step_ms"] for s in steps if 2 <= s["Itt"] <= 9)
    waits = sorted(s["data_wait_ms"] for s in steps + resumed)
    median = (loop_ms[3] + loop_ms[4]) / 2
    save = [re.search(r"in ([\d.]+) s, (\d+) bytes", ln).groups() for ln in saved]
    peak = re.search(r"peak device memory ([\d.]+) GiB", one_line(first, "Done at step")[0])
    first_loss = steps[0]["G_loss"], steps[-1]["G_loss"]
    say(f"train cli: {len(steps)} steps (epochs 0-1) in {wall1:.1f} s of wall time, then a "
        f"resume at step {resumed[0]['Itt']} for {len(resumed)} steps in {wall2:.1f} s; "
        f"every logged loss finite (G_loss {first_loss[0]:.4f} at step 0, {first_loss[1]:.4f} "
        f"at step 9); K1/K2 launches {STAGES * 2}/{STAGES * 2} in every step; validation K1 "
        f"launches {val_k1} per epoch ({STAGES} per utterance), sample dumps K1 "
        f"{[int(d[2]) for d in done]} (first run, resume); resumed state bit-identical to the saved one; step1-G.pt "
        f"re-imported bit-identical; sample max|y| {max(peaks):.4f}")
    say(f"train cli: loop step time, median of steps 2-9: {median:.2f} ms (min "
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
    from concurrent.futures import ThreadPoolExecutor

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
    summary = one_line(lines, "Converted ")[0]
    m = re.search(r"in (\d+) convert_batch calls: ([\d.]+) s of audio in ([\d.]+) s "
                  r"\(RTF ([\d.]+)x.*K1 launches (\d+); outputs (finite|NOT finite), "
                  r"max\|y\| ([\d.]+)", summary)
    calls, audio_s, conv_s, rtf, k1, finite, peak = m.groups()
    n_utt = len(TEST_SPK)
    convs = sorted(out.glob("*-conv.wav"))
    origs = sorted(out.glob("*-X-orig.wav"))
    log = (out / "conv_log.txt").read_text().splitlines()
    if (len(convs), len(origs), len(log)) != (n_utt * n_utt, n_utt, n_utt * n_utt):
        raise AssertionError(f"{len(convs)} conversions, {len(origs)} originals, "
                             f"{len(log)} log lines; expected {n_utt * n_utt}, {n_utt}, "
                             f"{n_utt * n_utt}")
    if finite != "finite" or float(peak) > 1.0:
        raise AssertionError(f"conversion outputs {finite}, max|y| {peak}")
    if int(k1) != STAGES * int(calls) or int(calls) != n_utt:
        raise AssertionError(f"{k1} K1 launches in {calls} convert_batch calls, expected "
                             f"{STAGES} per call and {n_utt} calls")
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


def ptxas_summary(log: str) -> list[str]:
    """'kernel: registers, spills' for every kernel in nvcc's -Xptxas -v output."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(cond_chain_fwd_kernel|k2_\w+?_kernel)"
                      r"((?:I(?:L[ib]\d+E)+E)?)", ln)
        if m:
            targs = re.findall(r"L[ib](\d+)E", m.group(2))
            name = m.group(1) + (f"<{','.join(targs)}>" if targs else "")
        elif name and "spill" in ln:
            out.append(f"{name}: {ln.strip()}")
        elif name and "registers" in ln:
            out[-1] += f", {ln.split(':', 1)[1].strip()}"
            name = None
    return out


def say_earlier(rows):
    """Each kernel's time in this run beside its EARLIER_MS entry."""
    for row in rows:
        ms, per = EARLIER_MS[row["name"]]
        say(f"earlier: {row['name']} {row['ms']:.3f} ms per {per} in this run "
            f"({row['ms'] / ms - 1:+.2%}); {ms:.3f} ms recorded in PERF.md for the "
            f"kernels with one fixed 128-row tile (not measured here)")


def main() -> int:
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

    _, build_s, log = cc_mod.build()
    say(f"build: {', '.join(src.name for src in cc_mod.SOURCES)} with nvcc, in parallel, "
        f"in {build_s:.1f} s; " + " | ".join(ptxas_summary(log)))

    cfg = Config()
    parity_err = phase_parity(cfg)
    convert_launches = phase_slice(cfg, card)
    k1_row = phase_kernel_times(cfg, card, convert_launches, parity_err)
    k2_err = phase_k2_parity(cfg)
    wide_parity(cfg, card)
    (train_k1, train_k2), bare_median = phase_train(cfg, card)
    k2_row = phase_k2_times(cfg, card, train_k2, k2_err)
    with tempfile.TemporaryDirectory() as tmp:
        root = write_corpus(Path(tmp))
        cli_k1, cli_k2 = phase_train_cli(root, card, bare_median)
        pipeline_beside_step(cfg, root, card)
        gen_k1 = phase_generate_cli(root, card)
        k1_row["max_abs_err"] = max(k1_row["max_abs_err"], cli_chain_parity(cfg, root, card))
    # K1 runs on every main path: conversion (phase 4), the train step
    # (phase 7) and the two CLIs (phases 9 and 10); K2 on the training paths
    k1_row["launches_by_path"] = {"convert": convert_launches, "train": train_k1,
                                  "train_cli": cli_k1, "generate_cli": gen_k1}
    k1_row["launches"] = sum(k1_row["launches_by_path"].values())
    k2_row["launches_by_path"] = {"train": train_k2, "train_cli": cli_k2}
    k2_row["launches"] = train_k2 + cli_k2
    say_earlier([k1_row, k2_row])
    say(f"total {time.perf_counter() - t_start:.1f} s [{card}]")
    say(json.dumps({"kernels": [k1_row, k2_row]}))
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
    adopt_orphans()
    try:
        rc = main()
    finally:
        end_children()
    sys.exit(rc)
