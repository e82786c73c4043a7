"""Seeded inputs that ``chip_smoke.py`` (on the card) and the CPU tests share.

The decoder's stage shapes and seeded cond-chain operands at one stage,
optionally rounded so that cond_0's products are exact; a CREPE-tiny
state dict in torchcrepe's layout, and a WavLM checkpoint in the Microsoft
layout, for the loaders of both packages.
"""

from __future__ import annotations

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
