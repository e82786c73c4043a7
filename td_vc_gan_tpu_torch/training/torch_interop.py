"""Reference (torch) checkpoint <-> the port's modules.

The port's own copy of ``td_vc_gan_tpu/training/torch_interop.py``. The
reference saves ``step{E}-{G,D,C}.pt`` torch state dicts (train.py:596-608)
with weight-normed convs stored as (weight_v, weight_g). The layout tables
below mirror the reference's ModuleList index arithmetic
(model/generator.py:197-362, discriminator.py:7-118, latent_classifier.py:8-38)
and name, for every reference layer, the port module that holds it: the
port's modules carry the JAX package's flax names, so an entry's
``flax_path`` joined with dots is the port's module path
(``decoder.stage_0_mrf.block_0_0.cond_0``). The port keeps torch's own
layouts, so only ``weight_g`` changes shape ((out, 1, 1) there, (out,) here).
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np
import torch


# kinds: how a reference torch layer's tensors map onto the port's parameters
#   conv      : Conv1d + weight_norm      -> v (out,in,k), g (out,), bias
#   conv_raw  : Conv1d plain              -> kernel (out,in,k), bias
#   convT     : ConvTranspose1d + wn      -> v (in,out,k), g (in,), bias
#   convT_raw : ConvTranspose1d plain     -> kernel (in,out,k), bias
#   linear    : nn.Linear                 -> kernel (out,in), bias


class Entry:
    def __init__(self, torch_prefix: str, flax_path: tuple[str, ...], kind: str,
                 has_bias: bool = True):
        self.torch_prefix = torch_prefix
        self.flax_path = flax_path
        self.kind = kind
        self.has_bias = has_bias


def _mrf_entries(tp: str, fp: tuple[str, ...], cond: bool, wn: bool,
                 n_kernels: int = 3, n_dilations: int = 3) -> list[Entry]:
    kind = "conv" if wn else "conv_raw"
    out = []
    for k in range(n_kernels):
        for j in range(n_dilations):
            base = f"{tp}.blocks.{k}.{j}"
            ours = fp + (f"block_{k}_{j}",)
            out.append(Entry(f"{base}.conv.1", ours + ("conv",), kind))
            out.append(Entry(f"{base}.posconv.1", ours + ("posconv",), kind))
            if cond:
                out.append(Entry(f"{base}.cond_var.0", ours + ("cond_0",), kind))
                out.append(Entry(f"{base}.cond_var.2", ours + ("cond_1",), kind))
    return out


def generator_entries(
    decoder_ratios: Iterable[int],
    content_dim: int | None = 128,
    num_bottleneck_layers: int = 0,
    encoder_model: str | None = None,
    weight_norm: tuple[bool, bool, bool] = (True, True, True),
    subsample_out: tuple[bool, ...] = (False, True, True, False),
    n_kernels: int = 3,
    n_dilations: int = 3,
    num_enc_layers: int = 16,
) -> list[Entry]:
    bot_wn, enc_wn, dec_wn = weight_norm
    ek = "conv" if enc_wn else "conv_raw"
    dk = "conv" if dec_wn else "conv_raw"
    n = len(list(decoder_ratios))
    has_proj = content_dim is not None

    e: list[Entry] = [Entry("embedding", ("embedding",), "linear")]

    if encoder_model == "wavlm":
        e.append(Entry("encoder.encoder.pre", ("encoder", "posterior", "pre"), "conv_raw"))
        e.append(Entry("encoder.encoder.proj", ("encoder", "posterior", "proj"), "conv_raw"))
        for i in range(num_enc_layers):
            e.append(Entry(
                f"encoder.encoder.enc.in_layers.{i}",
                ("encoder", "posterior", "enc", f"in_{i}"), "conv",
            ))
            e.append(Entry(
                f"encoder.encoder.enc.res_skip_layers.{i}",
                ("encoder", "posterior", "enc", f"res_skip_{i}"), "conv",
            ))
    else:
        e.append(Entry("encoder.encoder.0", ("encoder", "input_conv"), ek))
        for i in range(n):
            e.append(Entry(f"encoder.encoder.{3 + 4 * i}", ("encoder", f"stage_{i}_down"), ek))
            e += _mrf_entries(f"encoder.encoder.{4 + 4 * i}", ("encoder", f"stage_{i}_mrf"),
                              cond=False, wn=enc_wn,
                              n_kernels=n_kernels, n_dilations=n_dilations)
        base = 1 + 4 * n
        e.append(Entry(f"encoder.encoder.{base + 1}", ("encoder", "final_conv"), ek))
        if has_proj:
            e.append(Entry(f"encoder.encoder.{base + 3}", ("encoder", "proj"), ek, has_bias=False))

    # bottleneck (CIN/FiLM path, generator.py:468-470)
    for i in range(num_bottleneck_layers):
        b = f"bottleneck.{i}"
        ours = (f"bottleneck_{i}",)
        bk = "conv" if bot_wn else "conv_raw"
        e.append(Entry(f"{b}.conv.1", ours + ("conv",), bk))
        e.append(Entry(f"{b}.posconv.1", ours + ("posconv",), bk))
        e.append(Entry(f"{b}.cond_var.0", ours + ("cond_0",), bk))
        e.append(Entry(f"{b}.cond_var.2", ours + ("cond_1",), bk))

    # decoder
    off = 0
    if has_proj:
        e.append(Entry("decoder.decoder.1", ("decoder", "proj"), dk, has_bias=False))
        off = 2
    e.append(Entry(f"decoder.decoder.{off + 1}", ("decoder", "input_conv"), dk))
    for i in range(n):
        stage_base = off + 2 + 4 * i
        e.append(Entry(f"decoder.decoder.{stage_base + 2}", ("decoder", f"stage_{i}_up"),
                       "convT" if dec_wn else "convT_raw"))
        e += _mrf_entries(f"decoder.decoder.{stage_base + 3}", ("decoder", f"stage_{i}_mrf"),
                          cond=True, wn=dec_wn,
                          n_kernels=n_kernels, n_dilations=n_dilations)
    final_base = off + 2 + 4 * n
    e.append(Entry(f"decoder.decoder.{final_base + 2}", ("decoder", "output_conv"), dk))

    for i, tap in enumerate(subsample_out[:n]):
        if tap:
            e.append(Entry(f"decoder.subsample_out_layers.{i}.1",
                           ("decoder", f"subsample_out_{i}"), dk))

    for i in range(n):
        tp = f"decoder.excite_downsample.{i}"
        ours = ("decoder", f"excite_down_{i}")
        e.append(Entry(f"{tp}.block.0", ours + ("down_conv",), dk))
        e.append(Entry(f"{tp}.block.2", ours + ("conv_0",), dk))
        e.append(Entry(f"{tp}.block.4", ours + ("conv_1",), dk))
        e.append(Entry(f"{tp}.shortcut", ours + ("shortcut",), "conv_raw"))
    e.append(Entry(f"decoder.excite_downsample.{n}", ("decoder", f"excite_down_{n}"), dk))
    return e


def discriminator_entries(num_disc: int = 3, num_layers: int = 4) -> list[Entry]:
    e = []
    for d in range(num_disc):
        tp = f"discriminators.{d}"
        ours = (f"disc_{d}",)
        e.append(Entry(f"{tp}.discriminator.0.0", ours + ("input",), "conv"))
        for i in range(num_layers):
            e.append(Entry(f"{tp}.discriminator.{i + 1}.0", ours + (f"down_{i}",), "conv"))
        e.append(Entry(f"{tp}.discriminator.{num_layers + 1}.0", ours + ("pre_out",), "conv"))
        e.append(Entry(f"{tp}.output", ours + ("output",), "conv", has_bias=False))
    return e


def latent_classifier_entries(num_layers: int = 3) -> list[Entry]:
    e = []
    for i in range(num_layers):
        e.append(Entry(f"classifier.{1 + 2 * i}", (f"down_{i}",), "conv"))
    e.append(Entry(f"classifier.{1 + 2 * num_layers}", ("pre_out",), "conv"))
    e.append(Entry(f"classifier.{3 + 2 * num_layers}", ("output",), "conv", has_bias=False))
    return e

# ---------------------------------------------------------------------------
# tensor transforms
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _to_port(entry: Entry, sd: Mapping) -> dict[str, np.ndarray]:
    """One reference layer's tensors -> the port's ``{module.leaf: array}``."""
    tp, mp = entry.torch_prefix, ".".join(entry.flax_path)
    out = {}
    if entry.kind in ("conv", "convT"):
        out[f"{mp}.v"] = _np(sd[f"{tp}.weight_v"])
        out[f"{mp}.g"] = _np(sd[f"{tp}.weight_g"]).reshape(-1)
    elif entry.kind == "conv_raw":
        key = f"{tp}.weight" if f"{tp}.weight" in sd else f"{tp}.weight_v"
        out[f"{mp}.kernel"] = _np(sd[key])
    elif entry.kind in ("convT_raw", "linear"):
        out[f"{mp}.kernel"] = _np(sd[f"{tp}.weight"])
    else:
        raise ValueError(entry.kind)
    if entry.has_bias and f"{tp}.bias" in sd:
        out[f"{mp}.bias"] = _np(sd[f"{tp}.bias"])
    return out


def _to_torch(entry: Entry, state: Mapping) -> dict[str, np.ndarray]:
    """The port's tensors of one layer -> the reference's names and shapes."""
    tp, mp = entry.torch_prefix, ".".join(entry.flax_path)
    out = {}
    if entry.kind in ("conv", "convT"):
        out[f"{tp}.weight_v"] = _np(state[f"{mp}.v"])
        out[f"{tp}.weight_g"] = _np(state[f"{mp}.g"]).reshape(-1, 1, 1)
    elif entry.kind in ("conv_raw", "convT_raw", "linear"):
        out[f"{tp}.weight"] = _np(state[f"{mp}.kernel"])
    else:
        raise ValueError(entry.kind)
    if entry.has_bias and f"{mp}.bias" in state:
        out[f"{tp}.bias"] = _np(state[f"{mp}.bias"])
    return out


def torch_to_port(state_dict: Mapping, entries: list[Entry]) -> dict[str, np.ndarray]:
    """Reference torch state dict -> the port module's state, as numpy
    arrays under the port's names (the counterpart of ``torch_to_flax``)."""
    out: dict[str, np.ndarray] = {}
    for entry in entries:
        out.update(_to_port(entry, state_dict))
    return out


def port_to_torch(state: Mapping, entries: list[Entry]) -> dict[str, np.ndarray]:
    """The port module's state (``module.state_dict()``) -> the reference's
    torch state dict, as numpy arrays (the counterpart of ``flax_to_torch``)."""
    sd: dict[str, np.ndarray] = {}
    for entry in entries:
        sd.update(_to_torch(entry, state))
    return sd


def load_torch_file(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def save_torch_file(state_dict: Mapping, path) -> None:
    """Float32 CPU tensors, as the reference and the JAX package save them."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
                for k, v in state_dict.items()}, path)


def generator_entries_from_config(gen_cfg) -> list[Entry]:
    wnl = gen_cfg.weight_norm
    return generator_entries(
        gen_cfg.decoder_ratios,
        content_dim=gen_cfg.content_dim,
        num_bottleneck_layers=gen_cfg.num_bottleneck_layers,
        encoder_model=gen_cfg.encoder_model if gen_cfg.encoder_model != "conv" else None,
        weight_norm=(
            wnl.bottleneck == "weight_norm",
            wnl.encoder == "weight_norm",
            wnl.decoder == "weight_norm",
        ),
        n_kernels=len(gen_cfg.mrf_kernel_sizes),
        n_dilations=len(gen_cfg.mrf_dilations),
        num_enc_layers=gen_cfg.num_enc_layers,
    )
