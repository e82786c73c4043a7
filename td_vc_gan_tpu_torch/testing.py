"""Seeded inputs that ``chip_smoke.py`` (on the card) and the CPU tests share.

The decoder's stage shapes and seeded cond-chain operands at one stage,
optionally rounded so that cond_0's products are exact; a CREPE-tiny
state dict in torchcrepe's layout, a WavLM checkpoint in the Microsoft
layout, and a tiny Whisper checkpoint directory for transformers, for the
loaders of both packages. And a way to run W ranks, each its own process
in one process group (:func:`run_ranks`, :func:`call`), with the train step
on ranks (:func:`step_rank`) and the collectives' check
(:func:`collectives_probe`). And the generator parameters whose gradient a
norm slot cancels (:func:`norm_invariant`), which gradient checks hold to
vanish instead of to their own scale.
"""

from __future__ import annotations

import contextlib
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# kernel vs plain version: max|d| <= PARITY_RTOL * max|plain|
PARITY_RTOL = 1e-4


def stage_shapes(n_samples: int, cfg):
    """(T, C) of every decoder stage for an utterance of n_samples."""
    g = cfg.model.generator
    t = n_samples // g.total_ratio
    out = []
    for r, c in zip(g.decoder_ratios, g.decoder_channels[1:]):
        t *= r
        out.append((t, c))
    return out


def dyadic(x: torch.Tensor, step: float) -> torch.Tensor:
    """x rounded to a multiple of ``step`` (a power of two)."""
    return torch.round(x / step) * step


def chain_inputs(b, t, c, cfg, seed, exact_h: bool = False, e: int = 8,
                 device: str = "cuda", dtype=torch.float32):
    """Split-form and concat-form operands at a decoder stage, scaled like
    the seeded init, with E = ``e`` excitation channels (the decoder's 8 by
    default). ``exact_h`` rounds the conditioning to multiples of 1/8 and
    cond_0's weights to multiples of 1/256, and its bias to an odd multiple
    of 1/4096: every product then has at most 10 significant bits and every
    sum of them is exact in f32, so h is the same in any summation order,
    and with it the leaky_relu slope (1 or 0.2) that the backward picks at
    each element; and h is never exactly 0, where torch's F.leaky_relu
    backward (in the cuDNN yardstick) takes the slope 0.2 and the JAX
    package, K2 and the port's leaky_relu take 1. With unrounded inputs an
    element whose h lies within rounding of 0 takes one slope in one version
    and the other in the other; that is a property of the function, not an
    error of either version, and at the largest stage it does occur, in
    cuDNN's f32 backward as in the kernel's. The rounded operands of cond_0
    have at most 10 significant bits, so the kernels' 3xTF32 split takes
    them exactly (lo = 0).

    ``dtype`` (bfloat16 for the kernels' bf16 instances) rounds every operand
    once, after it is made in f32.

    Returns (split-form kwargs of ``cond_chain``, concat-form kwargs of
    ``film_cond_chain``, n, Cc)."""
    g = cfg.model.generator
    s = g.conditional_dim
    cc = s + e
    n = len(g.mrf_kernel_sizes) * len(g.mrf_dilations)
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, fan_in):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) / fan_in ** 0.5

    spk = torch.randn((b, s), generator=gen, device=device)
    exc = torch.randn((b, t, e), generator=gen, device=device)
    w0, b0 = u(3, cc, n * cc, fan_in=3 * cc), u(n * cc, fan_in=3 * cc)
    if exact_h:
        spk, exc = dyadic(spk, 1 / 8), dyadic(exc, 1 / 8)
        w0, b0 = dyadic(w0, 1 / 256), dyadic(b0, 1 / 256) + 1 / 4096
    w1, b1 = u(3, cc, n * 2 * c, fan_in=3 * cc), u(n * 2 * c, fan_in=3 * cc)
    w0_spk = w0[:, :s]
    split = dict(exc=exc, w0=w0[:, s:].contiguous(),
                 hbias=spk @ (w0_spk[0] + w0_spk[1] + w0_spk[2]) + b0,
                 w1=w1, b1=b1, edge0=spk @ w0_spk[0], edge_t=spk @ w0_spk[2])
    concat = dict(c=torch.cat([spk[:, None, :].expand(b, t, s), exc], -1).contiguous(),
                  w0=w0, b0=b0, w1=w1, b1=b1)
    if dtype != torch.float32:
        split, concat = ({k: v.to(dtype) for k, v in d.items()} for d in (split, concat))
    return split, concat, n, cc


def norm_invariant(G) -> set[str]:
    """The names of a Generator's parameters that only shift or scale a
    channel that a norm slot then normalises per channel over time: the
    input conv's bias and weight-norm gain ahead of a stack's first slot, and
    the bias of each MRF chain's last 1x1 conv ahead of the next slot (a
    constant over time). Their true gradient is 0 but for the norm's eps, so
    what a gradient check sees of them is rounding noise."""
    from td_vc_gan_tpu_torch.models.generator import Decoder, Encoder

    names = set()
    for stack in ("encoder", "decoder"):
        mod = getattr(G, stack)
        if not isinstance(mod, (Encoder, Decoder)) or mod.norm is None:
            continue
        names |= {f"{stack}.input_conv.{leaf}" for leaf in ("bias", "g")
                  if hasattr(mod.input_conv, leaf)}
        n = len(mod.ratios)
        for i in range(n):
            if not hasattr(mod, f"stage_{i + 1}_norm" if i + 1 < n else "final_norm"):
                continue
            mrf = getattr(mod, f"stage_{i}_mrf")
            names |= {f"{stack}.stage_{i}_mrf.{name}.posconv.bias" for name in mrf.block_names
                      if name.endswith(f"_{mrf.nd - 1}")}
    return names


def torchcrepe_state_dict(seed: int) -> dict:
    """A CREPE-tiny state dict in torchcrepe's layout (``conv{i}``,
    ``conv{i}_BN``, ``classifier``), with seeded values."""
    from td_vc_gan_tpu_torch.models.crepe import Crepe

    net = Crepe("tiny")
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    sd = {}
    for i in range(6):
        w = getattr(net, f"conv{i}_kernel")
        n = w.shape[0]
        sd[f"conv{i + 1}.weight"] = t(0.1 * rng.standard_normal((*w.shape, 1)))
        sd[f"conv{i + 1}.bias"] = t(0.1 * rng.standard_normal(n))
        sd[f"conv{i + 1}_BN.weight"] = t(rng.uniform(0.5, 1.5, n))
        sd[f"conv{i + 1}_BN.bias"] = t(0.1 * rng.standard_normal(n))
        sd[f"conv{i + 1}_BN.running_mean"] = t(0.1 * rng.standard_normal(n))
        sd[f"conv{i + 1}_BN.running_var"] = t(rng.uniform(0.5, 2, n))
    sd["classifier.weight"] = t(0.05 * rng.standard_normal(net.classifier_kernel.shape))
    sd["classifier.bias"] = torch.zeros(net.classifier_bias.shape)
    return sd


def microsoft_conv_layers(layers) -> str:
    """``conv_feature_layers`` written as the Microsoft cfg writes it:
    ``"[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"``."""
    runs: list[list] = []
    for layer in layers:
        if runs and runs[-1][0] == tuple(layer):
            runs[-1][1] += 1
        else:
            runs.append([tuple(layer), 1])
    return " + ".join(f"[({','.join(map(str, lay))})]" + (f" * {n}" if n > 1 else "")
                      for lay, n in runs)


def microsoft_wavlm_checkpoint(model) -> dict:
    """A port :class:`~td_vc_gan_tpu_torch.models.wavlm.WavLM` as a
    Microsoft WavLM ``.pt`` holds it: ``{"cfg": dict, "model": state dict}``,
    the cfg's ``conv_feature_layers`` a string, ``weight_g`` shaped (1, 1, k),
    and the pretraining-only ``mask_emb`` that the loaders skip."""
    import dataclasses

    from td_vc_gan_tpu_torch.models.wavlm import key_table

    cfg = model.cfg
    raw = dataclasses.asdict(cfg)
    del raw["compute_dtype"]  # the port's own field, not in Microsoft's cfg
    raw["conv_feature_layers"] = microsoft_conv_layers(cfg.conv_feature_layers)
    raw.update(dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0, mask_prob=0.0)
    sd = model.state_dict()
    out = {}
    for ms, ours in key_table(cfg):
        t = sd[ours].detach().cpu().clone()
        out[ms] = t.reshape(1, 1, -1) if ms.endswith("weight_g") else t
    out["mask_emb"] = torch.zeros(cfg.encoder_embed_dim)
    return {"cfg": raw, "model": out}


def tiny_whisper_checkpoint(d, seed: int = 0) -> str:
    """Write a 2-layer Whisper (d_model 32, a character vocabulary, greedy
    decoding of at most 24 tokens) with its processor into directory ``d``,
    for transformers' ASR pipeline; returns ``d``. transformers is imported
    here only."""
    import json
    import os

    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration, WhisperProcessor,
                              WhisperTokenizer)

    d = str(d)
    os.makedirs(d, exist_ok=True)
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                "<|translate|>", "<|notimestamps|>", "<|nospeech|>"]
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["'", ".", ","]
    vocab = {t: i for i, t in enumerate(specials + chars)}
    vocab["\u0120"] = len(vocab)  # byte-level BPE space marker
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    eot = "<|endoftext|>"
    tok = WhisperTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"),
                           unk_token=eot, bos_token=eot, eos_token=eot, pad_token=eot)
    proc = WhisperProcessor(feature_extractor=WhisperFeatureExtractor(feature_size=80),
                            tokenizer=tok)
    cfg = WhisperConfig(
        vocab_size=len(vocab), num_mel_bins=80, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, d_model=32, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_source_positions=1500, max_target_positions=448,
        decoder_start_token_id=vocab["<|startoftranscript|>"], eos_token_id=vocab[eot],
        pad_token_id=vocab[eot], bos_token_id=vocab[eot])
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(cfg)
    gc = model.generation_config
    gc.forced_decoder_ids = None
    gc.begin_suppress_tokens = None
    gc.suppress_tokens = None
    gc.max_length = 24
    gc.no_timestamps_token_id = vocab["<|notimestamps|>"]
    model.save_pretrained(d)
    proc.save_pretrained(d)
    return d


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


_CALL = ("import importlib, sys; mod, fn = sys.argv[1].split(':'); "
         "getattr(importlib.import_module(mod), fn)(*sys.argv[2:])")


def call(target: str, *args: str):
    """The command of :func:`run_ranks` that calls ``target``
    (``"module:function"``) as ``function(rank, world, address, *args)``."""
    return lambda rank, world, address: [sys.executable, "-c", _CALL, target, str(rank),
                                         str(world), address, *args]


def run_ranks(world: int, command, timeout: float = 300.0) -> list[str]:
    """Run ``command(rank, world, address)`` (an argv) for each of ``world``
    ranks, each its own process, started together from this package's
    parent directory; ``address`` is a free ``127.0.0.1:port`` for the
    process group. Returns each rank's output (stdout and stderr). If a rank
    fails or the time runs out, the others (which may wait in a collective
    for it) are ended and this raises with every rank's output."""
    address = f"127.0.0.1:{free_port()}"
    with contextlib.ExitStack() as files:
        logs = [files.enter_context(tempfile.TemporaryFile("w+")) for _ in range(world)]
        procs = [subprocess.Popen(command(rank, world, address),
                                  cwd=Path(__file__).resolve().parents[1], stdout=log,
                                  stderr=subprocess.STDOUT, text=True)
                 for rank, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("ranks failed: " + "".join(
            f"\n--- rank {r} (exit {p.returncode}):\n{out}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    return outs


def _join(rank: int, world: int, address: str, device: str, backend: str) -> torch.device:
    """Join a process group of ``world`` ranks (one too) at ``address`` on
    ``device`` ("cuda": the rank's own card, ``cuda:{rank % count}``)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    return dev


def step_rank(rank, world, address, payload: str, out: str, device: str = "cpu",
              backend: str = "gloo") -> None:
    """One rank of the train step, for :func:`run_ranks` through :func:`call`. ``payload`` (a
    ``torch.save`` file) holds cfg, the modules G, D, C (or None) and crepe,
    the global batch (numpy), ``draws`` for the first step (global-shaped, or
    None), ``seed`` of the generator the other steps draw from, and
    ``steps``. The rank takes its rows of the batch, runs the steps under the
    process group (f32 with TF32 off, as the train CLI), on ``device``
    ("cuda": its own card), and writes ``out/rank{r}.pt``: each step's metrics,
    milliseconds and (K1, K2) launches, the state after the first step
    (parameters and first moments of G, D and C), the generator's state, and
    the time of one mean of G's and D's gradients across the ranks (``ms``
    and bytes)."""
    import torch.distributed as dist

    from td_vc_gan_tpu_torch import parallel
    from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cc_mod
    from td_vc_gan_tpu_torch.training import state as state_mod
    from td_vc_gan_tpu_torch.training import step as step_mod

    dev = _join(int(rank), int(world), address, device, backend)
    rank, world = parallel.rank_world()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    blob = torch.load(payload, weights_only=False)
    cfg = blob["cfg"]
    nets = {k: None if blob[k] is None else blob[k].to(dev) for k in ("G", "D", "C", "crepe")}
    state = state_mod.create_train_state(cfg, nets["G"], nets["D"], nets["C"], nets["crepe"])
    step = step_mod.build_train_step(cfg, state, dist.group.WORLD)
    b = parallel.local_batch(len(blob["batch"]["signal"]), world)
    batch = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(dev)
             for k, v in blob["batch"].items()}
    gen = torch.Generator(device=dev).manual_seed(blob["seed"])
    result = {"metrics": [], "ms": [], "launches": []}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for i in range(blob["steps"]):
        k0 = cc_mod.kernel_launches(cfg.train.compute_dtype)
        sync()
        t0 = time.perf_counter()
        metrics = step(batch, gen, blob["draws"] if i == 0 else None)
        sync()
        result["ms"].append((time.perf_counter() - t0) * 1e3)
        k1 = cc_mod.kernel_launches(cfg.train.compute_dtype)
        result["launches"].append((k1[0] - k0[0], k1[1] - k0[1]))
        result["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            result["state"] = {
                tag: {"params": {n: p.detach().cpu().clone() for n, p in net.named_parameters()},
                      "exp_avg": {n: opt.optimizer.state[p]["exp_avg"].cpu().clone()
                                  for n, p in net.named_parameters()
                                  if p in opt.optimizer.state}}
                for tag, net, opt in (("G", state.G, state.opt_g), ("D", state.D, state.opt_d),
                                      ("C", state.C, state.opt_c)) if net is not None}
    result["generator"] = gen.get_state()
    grads = [p.grad for p in state.opt_g.params + state.opt_d.params]
    ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        parallel.mean_(grads)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    result["all_reduce"] = {"ms": sorted(ms)[1], "bytes": 4 * sum(g.numel() for g in grads)}
    torch.save(result, Path(out) / f"rank{rank}.pt")
    dist.destroy_process_group()


def collectives_probe(rank, world, address) -> None:
    """For :func:`run_ranks` through :func:`call`, on the CPU: every collective of ``parallel``
    over gloo, each against the value it must give exactly, which every rank
    computes from all ranks' seeded inputs; prints ``ok``."""
    import torch.distributed as dist

    from td_vc_gan_tpu_torch import parallel
    from td_vc_gan_tpu_torch.parallel import mesh

    rank, world = int(rank), int(world)
    _join(rank, world, address, "cpu", "gloo")
    assert parallel.rank_world() == (rank, world)

    def inputs(r):
        g = torch.Generator().manual_seed(r)
        return [torch.randn(shape, generator=g) for shape in ((3, 5), (7,), (2, 2, 4), ())]

    mesh.BUCKET = 20  # several buckets, one tensor alone in its own
    got = inputs(rank)
    parallel.mean_(got)
    for i, t in enumerate(got):
        want = sum(inputs(r)[i] for r in range(world)) / world
        assert torch.equal(t, want), i
    metrics = parallel.mean_metrics({"a": torch.tensor(float(rank)), "b": torch.tensor(2.0)})
    assert float(metrics["a"]) == sum(range(world)) / world and float(metrics["b"]) == 2.0
    labels = torch.arange(3) + 10 * rank
    assert torch.equal(parallel.gather_rows(labels),
                       torch.cat([torch.arange(3) + 10 * r for r in range(world)]))
    rows = parallel.gather_rows(inputs(rank)[0])
    assert torch.equal(rows, torch.cat([inputs(r)[0] for r in range(world)]))
    parallel.check_replicas("ab" * 32, "cpu")
    try:
        parallel.check_replicas(("ab" if rank else "cd") * 32, "cpu")
    except RuntimeError as err:
        assert "differs" in str(err)
    else:
        raise AssertionError("check_replicas let differing states pass")
    parallel.barrier("cpu")
    dist.destroy_process_group()
    print("ok")

