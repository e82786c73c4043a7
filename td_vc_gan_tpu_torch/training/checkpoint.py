"""Checkpoints: the port's full train state, and the reference's ``.pt`` files.

Counterpart of ``td_vc_gan_tpu/training/checkpoint.py``. The reference writes
``step{E}-{G,D,C}.pt`` and ``latest-*`` aliases every ``save_interval`` epochs
and keeps no optimizer state (train.py:596-608). The JAX package keeps its
full TrainState with Orbax under ``<run>/orbax/epoch_{E}``; the port keeps its
own (G, D, C, their AdamW/Adam states and the step) with ``torch.save`` under
``<run>/torch_state/epoch_{E}.pt``, found again by :func:`latest_epoch`. With
the WavLM encoder that state carries the frozen backbone, as the JAX
package's does (WavLM-Large adds 1.26 GB per save), and the backbone's
config, so that a run's conversion rebuilds the backbone it trained with. The
reference-format files are written beside it (:func:`export_torch`), so that
the JAX package, the reference's tooling and the port read each other's
weights. Restoring a reference file merges it permissively into the model
(:func:`load_possible`, util/__init__.py:64-89).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from td_vc_gan_tpu_torch.models.wavlm import WavLMConfig
from td_vc_gan_tpu_torch.training import torch_interop as ti
from td_vc_gan_tpu_torch.training.state import TrainState

STATE_DIR = "torch_state"


def _state_file(path: str | Path, epoch: int) -> Path:
    return Path(path) / STATE_DIR / f"epoch_{epoch}.pt"


def save_state(state: TrainState, path: str | Path, epoch: int,
               compute_dtype: str = "float32") -> Path:
    """The whole train state at the end of ``epoch``: model weights, the
    optimizers' moments and step counts, the train step's counter and the
    run's ``train.compute_dtype``."""
    out = _state_file(path, epoch)
    out.parent.mkdir(parents=True, exist_ok=True)
    blob = {"step": state.step,
            "G": state.G.state_dict(), "D": state.D.state_dict(),
            "opt_g": state.opt_g.optimizer.state_dict(),
            "opt_d": state.opt_d.optimizer.state_dict(),
            "compute_dtype": compute_dtype}
    if state.C is not None:
        blob.update(C=state.C.state_dict(), opt_c=state.opt_c.optimizer.state_dict())
    if (wavlm := backbone(state.G)) is not None:
        blob["wavlm_cfg"] = dataclasses.asdict(wavlm.cfg)
    tmp = out.with_suffix(".tmp")
    torch.save(blob, tmp)
    tmp.replace(out)
    return out


def backbone(G: torch.nn.Module):
    """G's WavLM backbone, or None for the conv encoder."""
    return getattr(G.encoder, "wavlm", None)


def load_state_file(path: str | Path, epoch: int) -> dict:
    """The saved train state of ``epoch``, its tensors on the CPU and mapped
    from the file, not read, until used."""
    return torch.load(_state_file(path, epoch), map_location="cpu", weights_only=False,
                      mmap=True)


def state_wavlm_cfg(blob: Mapping) -> WavLMConfig | None:
    """The WavLM backbone's config recorded in a saved train state, if any."""
    return WavLMConfig(**blob["wavlm_cfg"]) if "wavlm_cfg" in blob else None


def load_backbone(G: torch.nn.Module, blob: Mapping) -> None:
    """Fill G's WavLM backbone from a saved train state's G."""
    prefix = "encoder.wavlm."
    backbone(G).load_state_dict({k[len(prefix):]: v for k, v in blob["G"].items()
                                 if k.startswith(prefix)})


def latest_epoch(path: str | Path) -> int | None:
    """The newest epoch with a saved train state under ``path``, or None."""
    d = Path(path) / STATE_DIR
    epochs = sorted(int(p.stem.split("_")[1]) for p in d.glob("epoch_*.pt")) if d.exists() else []
    return epochs[-1] if epochs else None


def has_state(path: str | Path, epoch: int) -> bool:
    return _state_file(path, epoch).exists()


def restore_state(state: TrainState, path: str | Path, epoch: int | None = None) -> list[str]:
    """Load a saved train state into ``state`` (in place; G and D must have
    been built for the same architecture) and return the names of the nets
    it restored. A latent classifier that the saved state lacks (a stage-1
    run handing off to stage 2-1) keeps its weights from the seed and a fresh
    optimizer, as in the reference's ``train.py``, which loads whichever of
    ``step{E}-{G,D,C}.pt`` exist."""
    if epoch is None:
        epoch = latest_epoch(path)
        if epoch is None:
            raise FileNotFoundError(f"no saved train state under {Path(path) / STATE_DIR}")
    blob = load_state_file(path, epoch)
    state.G.load_state_dict(blob["G"])
    state.D.load_state_dict(blob["D"])
    state.opt_g.optimizer.load_state_dict(blob["opt_g"])
    state.opt_d.optimizer.load_state_dict(blob["opt_d"])
    restored = ["G", "D"]
    if state.C is not None and "C" in blob:
        state.C.load_state_dict(blob["C"])
        state.opt_c.optimizer.load_state_dict(blob["opt_c"])
        restored.append("C")
    state.step = int(blob["step"])
    return restored


# ---------------------------------------------------------------------------
# reference-format export/import (step{E}-G.pt naming, train.py:596-608)
# ---------------------------------------------------------------------------


def generator_entries(cfg):
    return ti.generator_entries_from_config(cfg.model.generator)


def discriminator_entries(cfg):
    d = cfg.model.discriminator
    return ti.discriminator_entries(d.num_disc, d.num_layers)


def export_torch(state: TrainState, cfg, save_path: str | Path, epoch: int,
                 with_latest: bool = True) -> None:
    """``step{epoch}-{G,D[,C]}.pt`` (and ``latest-*.pt`` and
    ``latest_epoch``) in the reference's format."""
    save_path = Path(save_path)
    files = [("G", state.G, generator_entries(cfg)), ("D", state.D, discriminator_entries(cfg))]
    if state.C is not None:
        files.append(("C", state.C, ti.latent_classifier_entries()))
    for tag, module, entries in files:
        sd = ti.port_to_torch(module.state_dict(), entries)
        ti.save_torch_file(sd, save_path / f"step{epoch}-{tag}.pt")
        if with_latest:
            ti.save_torch_file(sd, save_path / f"latest-{tag}.pt")
    (save_path / "latest_epoch").write_text(str(epoch))


def _jax_name(name: str) -> str:
    return "params/" + name.replace(".", "/")


def load_possible(params: Mapping, new_params: Mapping) -> tuple[dict, dict]:
    """Permissive partial load (util/__init__.py:64-89) of flat ``{name:
    array}`` dicts: matching entries are copied, entries of another shape are
    copied over their common leading slice, and the names are reported in
    the JAX package's categories and spelling (``params/decoder/...``)."""
    messages = {"matched": [], "mismatched_size": [], "unmatched_keys": [], "missing_keys": []}
    out = {k: np.asarray(v) for k, v in params.items()}
    for k, v in new_params.items():
        name = _jax_name(k)
        if k not in params:
            messages["unmatched_keys"].append(name)
            continue
        old = np.asarray(params[k])
        new = np.asarray(v)
        if old.shape == new.shape:
            out[k] = new
            messages["matched"].append(name)
        else:
            sl = tuple(slice(0, min(o, n)) for o, n in zip(old.shape, new.shape))
            merged = old.copy()
            merged[sl] = new[sl]
            out[k] = merged
            messages["mismatched_size"].append(name)
    for k in params:
        if k not in new_params:
            messages["missing_keys"].append(_jax_name(k))
    return out, messages


def _import(module: torch.nn.Module, path, entries) -> dict:
    """Merge a reference ``.pt`` file into ``module`` permissively; the
    load_possible messages."""
    new = ti.torch_to_port(ti.load_torch_file(path), entries)
    old = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    merged, messages = load_possible(old, new)
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in merged.items()})
    return messages


def import_torch_generator(cfg, path: str | Path, G: torch.nn.Module) -> dict:
    """Load a reference ``*-G.pt`` into the port's Generator ``G``."""
    return _import(G, path, generator_entries(cfg))


def import_torch_discriminator(cfg, path: str | Path, D: torch.nn.Module) -> dict:
    return _import(D, path, discriminator_entries(cfg))


def import_torch_classifier(path: str | Path, C: torch.nn.Module) -> dict:
    return _import(C, path, ti.latent_classifier_entries())
