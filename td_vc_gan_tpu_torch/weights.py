"""Weights from the JAX package's flax parameter trees into the port's modules.

The port's modules carry the flax names (``decoder.stage_0_mrf.block_0_0.
cond_0.v`` for ``params/decoder/stage_0_mrf/block_0_0/cond_0/v``), so the
mapping is by name; only the layouts differ:

- weight-normed conv ``v`` (k, in, out) -> (out, in, k), ``g`` per output;
- transposed conv ``v`` (in, out, k) stays, ``g`` per input;
- plain conv ``kernel`` (k, in, out) -> (out, in, k);
- Linear ``kernel`` (in, out) -> (out, in) (the speaker embedding, and a
  conditional instance norm's ``Linear_0`` on a 2-D cond; its per-frame
  ``WNConv1d_0`` is a plain conv);
- the WavLM backbone's bare arrays (``models/wavlm.py``), kept in the
  Microsoft checkpoint's torch layouts: extractor ``conv_i`` (k, in, out)
  -> (out, in, k); every ``*_kernel`` (in, out) -> (out, in), applied as
  ``F.linear``; ``pos_conv_v`` (k, d/g, d) -> (d, d/g, k); ``pos_conv_g``
  (k,), ``grep_a`` (1, H, 1, 1) and ``rel_attn_bias`` (buckets, H) as they
  are.

Every parameter and buffer must be matched exactly once; anything missing,
left over or of the wrong shape raises.

The evaluation models' JAX parameters are flat dicts: ECAPA's are keyed by
speechbrain's names with conv kernels (k, in, out), which go back to
(out, in, k); MOSNet's are its Keras slots, which ``models.mosnet.load_slots``
reads.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from td_vc_gan_tpu_torch.models import mosnet
from td_vc_gan_tpu_torch.models.crepe import Crepe
from td_vc_gan_tpu_torch.models.ecapa import ECAPA, from_torch_state_dict
from td_vc_gan_tpu_torch.models.f0_estimator import F0Estimator
from td_vc_gan_tpu_torch.models.layers import Linear, WNConv1d
from td_vc_gan_tpu_torch.models.wavlm import (
    ConvFeatureExtractor,
    EncoderLayer,
    MultiheadAttention,
    TransformerEncoder,
    WavLM,
)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.array(value, dtype=np.float32)
    return out


def _params(tree: Mapping) -> dict[str, np.ndarray]:
    return _flatten(tree["params"] if "params" in tree else tree)


def _load(module: nn.Module, flat: dict[str, np.ndarray], layout) -> nn.Module:
    targets = module.state_dict(keep_vars=True)  # parameters and stored buffers
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, t in targets.items():
            value = torch.from_numpy(layout(name, flat[name]))
            if value.shape != t.shape:
                raise ValueError(f"{name}: JAX shape {flat[name].shape} gives "
                                 f"{tuple(value.shape)}, the port has {tuple(t.shape)}")
            t.copy_(value)
    return module


def _conv_layout(module: nn.Module):
    """The flax-to-torch layout of every leaf of ``module``, by its owner."""
    owners = dict(module.named_modules())

    def layout(name: str, a: np.ndarray) -> np.ndarray:
        owner, leaf = owners[name.rpartition(".")[0]], name.rpartition(".")[2]
        if isinstance(owner, Linear) and leaf == "kernel":
            return np.ascontiguousarray(a.T)
        if isinstance(owner, WNConv1d) and leaf in ("v", "kernel"):
            return np.ascontiguousarray(a.transpose(2, 1, 0))
        if isinstance(owner, ConvFeatureExtractor) and not leaf.endswith("_bias"):
            return np.ascontiguousarray(a.transpose(2, 1, 0))  # conv_i
        if isinstance(owner, TransformerEncoder) and leaf == "pos_conv_v":
            return np.ascontiguousarray(a.transpose(2, 1, 0))
        if isinstance(owner, (MultiheadAttention, EncoderLayer, WavLM)) and \
                leaf.endswith("_kernel"):
            return np.ascontiguousarray(a.T)
        return a

    return layout


def generator_from_jax(G: nn.Module, params_np: Mapping) -> nn.Module:
    """Fill the port's Generator ``G`` from the JAX Generator's parameter
    tree (numpy leaves, with or without the top ``params`` level)."""
    return _load(G, _params(params_np), _conv_layout(G))


def discriminator_from_jax(D: nn.Module, params_np: Mapping) -> nn.Module:
    """Fill the port's CollaborativeMultibandDiscriminator (or a single
    Discriminator) from the JAX module's parameter tree."""
    return _load(D, _params(params_np), _conv_layout(D))


def classifier_from_jax(C: nn.Module, params_np: Mapping) -> nn.Module:
    """Fill the port's LatentClassifier from the JAX module's parameter tree."""
    return _load(C, _params(params_np), _conv_layout(C))


def f0_estimator_from_jax(net: F0Estimator, params_np: Mapping) -> F0Estimator:
    """Fill the port's F0Estimator from the JAX F0Estimator's parameter tree."""
    return _load(net, _params(params_np), _conv_layout(net))


def crepe_from_jax(net: Crepe, params_np: Mapping) -> Crepe:
    """Fill the port's CREPE from the JAX CREPE's parameter tree, batch-norm
    statistics included."""

    def layout(name: str, a: np.ndarray) -> np.ndarray:
        if name == "classifier_kernel":
            return np.ascontiguousarray(a.T)
        if name.endswith("_kernel"):
            return np.ascontiguousarray(a.transpose(2, 1, 0))
        return a

    return _load(net, _params(params_np), layout)


def ecapa_from_jax(model: ECAPA, params_np: Mapping) -> ECAPA:
    """Fill the port's ECAPA from the JAX package's ECAPA parameters (the
    flat dict of ``from_torch_state_dict`` in ``td_vc_gan_tpu/models/ecapa.py``, numpy
    leaves), ``classifier.weight`` included when present."""
    sd = {}
    for key, a in params_np.items():
        a = np.asarray(a, dtype=np.float32)
        if key.endswith("conv.weight") and a.ndim == 3:
            a = a.transpose(2, 1, 0)
        sd[key] = np.ascontiguousarray(a)
    csd = {"weight": sd["classifier.weight"]} if "classifier.weight" in sd else None
    return from_torch_state_dict(model, sd, csd)


def mosnet_from_jax(model: mosnet.MOSNet, params_np: Mapping) -> mosnet.MOSNet:
    """Fill the port's MOSNet from the JAX package's MOSNet parameters (its
    Keras slot dict, numpy leaves)."""
    return mosnet.load_slots(model, {k: np.asarray(v) for k, v in params_np.items()})
