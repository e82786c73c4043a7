#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card (Hopper:
the kernel is built for sm_90a) and the CUDA toolkit. It needs no network
and no weights: everything is made from seeds. Phases, one line or more each:

1. card: name and power limit (nvidia-smi) and torch's device name;
2. build: nvcc compiles every kernel of the conversion path;
3. parity: the FiLM cond-chain kernel against its plain PyTorch version at
   the four decoder-stage shapes of an 8960-sample segment (B=2), split and
   concat forms;
4. slice: the full-width conv-encoder Converter runs pitch_batch (Viterbi)
   and convert_batch on 16 x 71680 samples: output checks, kernel launches
   counted over that run, the same call with the plain chain, a small input
   against the CPU path, the conversion real-time factor, and one convert
   call's device time by kernel (torch.profiler);
5. kernel times at the main path's four stage shapes beside the bound, the
   plain version and a cuDNN sequence (a yardstick the port never calls).

Float32 throughout, with TF32 off in cuDNN and matmul: the port's compute
type is f32, as the JAX package's default. Any failed check raises, and the
script then exits non-zero without its result lines. The last two lines are
the JSON kernel table and the result object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import crepe_from_seed
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cc_mod

PEAK_F32_FLOPS = 67e12    # H100 SXM, f32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 (data sheet)
PARITY_RTOL = 1e-4        # kernel vs plain: max|d| <= 1e-4 * max|plain|
AUDIO_ATOL = 1e-3         # converted audio (in [-1, 1]): kernel path vs plain / CPU path
B, UTT = 16, 71680        # the conversion batch the JAX package measured
SEG = 8960                # the training segment, for the parity phase


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


def stage_shapes(n_samples: int, cfg):
    """(T, C) of every decoder stage for an utterance of n_samples."""
    g = cfg.model.generator
    t = n_samples // g.total_ratio
    out = []
    for r, c in zip(g.decoder_ratios, g.decoder_channels[1:]):
        t *= r
        out.append((t, c))
    return out


def chain_inputs(b, t, c, cfg, seed):
    """Split-form operands at a decoder stage, scaled like the seeded init."""
    g = cfg.model.generator
    s, e = g.conditional_dim, 8
    cc = s + e
    n = len(g.mrf_kernel_sizes) * len(g.mrf_dilations)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def u(*shape, fan_in):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) / fan_in ** 0.5

    spk = torch.randn((b, s), generator=gen, device="cuda")
    exc = torch.randn((b, t, e), generator=gen, device="cuda")
    w0, b0 = u(3, cc, n * cc, fan_in=3 * cc), u(n * cc, fan_in=3 * cc)
    w1, b1 = u(3, cc, n * 2 * c, fan_in=3 * cc), u(n * 2 * c, fan_in=3 * cc)
    w0_spk = w0[:, :s]
    split = dict(exc=exc, w0=w0[:, s:].contiguous(),
                 hbias=spk @ (w0_spk[0] + w0_spk[1] + w0_spk[2]) + b0,
                 w1=w1, b1=b1, edge0=spk @ w0_spk[0], edge_t=spk @ w0_spk[2])
    concat = dict(c=torch.cat([spk[:, None, :].expand(b, t, s), exc], -1).contiguous(),
                  w0=w0, b0=b0, w1=w1, b1=b1)
    return split, concat, n, cc


def rel_err(got, want) -> tuple[float, float]:
    d = float((got - want).abs().max())
    return d, d / max(float(want.abs().max()), 1e-30)


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


def signals(seed: int) -> np.ndarray:
    """B voiced-like utterances: a gliding harmonic tone per row plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(UTT) / 16000
    f0 = rng.uniform(90, 260, (B, 1)) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 16000
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    return (0.2 * x + 0.01 * rng.standard_normal((B, UTT))).astype(np.float32)


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
    profile_convert(lambda: conv.convert_tensors(*args, lab, seed=1), card)
    return launches


def profile_convert(fn, card, top: int = 10):
    """Device time of one convert call by kernel name (torch.profiler), and
    the share of the call's wall time the card was busy."""
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
    say(f"profile: one convert call {wall_ms:.2f} ms wall (profiler on), kernels busy "
        f"{busy:.2f} ms ({busy / wall_ms:.1%}), {sum(v[1] for v in by_name.values())} "
        f"kernel launches [{card}]")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"profile: {ms:8.3f} ms {ms / busy:6.1%} x{count:<5d} {name[:90]}")


def phase_kernel_times(cfg, card, launches, parity_err):
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    worst = parity_err
    for i, (t, c) in enumerate(stage_shapes(UTT, cfg)):
        split, concat, n, cc = chain_inputs(B, t, c, cfg, seed=200 + i)
        e = split["exc"].shape[-1]
        d, r = rel_err(cc_mod.cond_chain(**split), cc_mod.cond_chain_plain(**split))
        if r > PARITY_RTOL:
            raise AssertionError(f"cond-chain kernel disagrees with its plain version at "
                                 f"main-path stage {i}: {r:.2e} of max|ref|")
        worst = max(worst, d)
        k_ms = cuda_ms(lambda: cc_mod.cond_chain(**split), iters=5, warmup=2)
        p_ms = cuda_ms(lambda: cc_mod.cond_chain_plain(**split), iters=3)
        w0c = concat["w0"].permute(2, 1, 0)
        w1g = concat["w1"].permute(2, 1, 0)
        cin = concat["c"].transpose(1, 2).contiguous()

        def cudnn_chain():
            h = F.leaky_relu(F.conv1d(cin, w0c, concat["b0"], padding=1), 0.2)
            return F.conv1d(h, w1g, concat["b1"], padding=1, groups=n)

        l_ms = cuda_ms(cudnn_chain, iters=3)
        flops = 2.0 * B * t * (n * cc * 3 * e + n * 2 * c * 3 * cc)
        nbytes = 4.0 * (sum(x.numel() for x in split.values()) + B * t * n * 2 * c)
        bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        say(f"kernel stage {i}: B={B} T={t} C={c}: kernel {k_ms:.3f} ms, bound {bound:.3f} ms "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB; "
            f"{flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s achieved), plain {p_ms:.3f} ms, "
            f"cuDNN conv1d+lrelu+grouped conv1d {l_ms:.3f} ms, launches per convert 1, "
            f"max|d| vs plain {d:.2e} [{card}]")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                       ("library_ms", l_ms), ("flops", flops), ("bytes", nbytes)):
            totals[key] += v
        del split, concat
        torch.cuda.empty_cache()
    bound_by = ("operations" if totals["flops"] / PEAK_F32_FLOPS >= totals["bytes"] / PEAK_BYTES
                else "bytes")
    say(f"kernel per convert call (4 stages): {totals['ms']:.3f} ms against a bound of "
        f"{totals['bound_ms']:.3f} ms ({bound_by}), {totals['bound_ms'] / totals['ms']:.1%} "
        f"of it [{card}]")
    return {"name": "cond_chain_fwd", "route": "cuda",
            "source": "td_vc_gan_tpu_torch/csrc/cond_chain.cu",
            "replaces": "td_vc_gan_tpu/ops/pallas/cond_chain.py:157",
            "launches": launches, "max_abs_err": worst,
            "ms": totals["ms"], "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"], "bound_by": bound_by,
            "library_ms": totals["library_ms"]}


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
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say(f"build: {cc_mod.SOURCE.name} with nvcc in {build_s:.1f} s; " + " | ".join(ptxas))

    cfg = Config()
    parity_err = phase_parity(cfg)
    launches = phase_slice(cfg, card)
    row = phase_kernel_times(cfg, card, launches, parity_err)
    say(f"total {time.perf_counter() - t_start:.1f} s [{card}]")
    say(json.dumps({"kernels": [row]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
