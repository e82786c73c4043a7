"""Many-to-many conversion over a test manifest: every utterance to every
speaker of the manifest, with the target's F0 statistics taken from an
utterance of that speaker (the reference's generate_with_target.py:54-184).

Counterpart of ``td_vc_gan_tpu/cli/generate_with_target.py``, with the same
arguments plus ``--device``, the same file names and the same
``conv_log.txt``. Each utterance goes to all targets in one
``Converter.convert_batch`` call.

Outputs ``{phrase}-{src}-{tgt}-conv.wav``, ``{phrase}-{src}-X-orig.wav`` and
``conv_log.txt`` in ``--save_path``.

Usage:
    python -m td_vc_gan_tpu_torch.cli.generate_with_target --save_path out \
        --load_path runs/exp --data_path data/vctk [--epoch N] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import time
from pathlib import Path

import numpy as np
import torch

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.config import load_config
from td_vc_gan_tpu_torch.data.audio_io import write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import crepe_from_seed
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cc_mod
from td_vc_gan_tpu_torch.training import checkpoint as ckpt


def parse_fn(filename: str, dataset_format: str) -> str:
    """Phrase-id extraction per dataset (generate_with_target.py:41-51)."""
    base = os.path.basename(filename)
    if dataset_format == "vctk":
        return re.match(r"(\S+)_(\d+).wav", base).group(2)
    if dataset_format == "alcaim":
        return re.match(r"(\S+)-(\d+).wav", base).group(2)
    if dataset_format == "smt":
        return re.match(r"list(\S+).wav", base).group(1)
    return os.path.splitext(base)[0]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save_path", required=True)
    p.add_argument("--load_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--data_file", default="test_files")
    p.add_argument("--config_file", default=None)
    p.add_argument("--epoch", default=None)
    p.add_argument("--data_format", default="vctk")
    p.add_argument("--crepe_weights", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def load_generator(cfg, load_path: Path, epoch, num_spk: int, device=None):
    """G with weights from ``step{epoch}-G.pt`` / ``latest-G.pt`` in the
    reference's format, else from the port's newest full train state."""
    G = generator_from_config(cfg.model.generator, num_spk, device, seed=0)
    g_file = load_path / (f"step{epoch}-G.pt" if epoch is not None else "latest-G.pt")
    if g_file.exists():
        msg = ckpt.import_torch_generator(cfg, g_file, G)
        print(f"Loaded {g_file} ({len(msg['matched'])} tensors)")
        return G
    se = ckpt.latest_epoch(load_path)
    if se is not None:
        blob = torch.load(load_path / ckpt.STATE_DIR / f"epoch_{se}.pt", map_location="cpu",
                          weights_only=False)
        G.load_state_dict(blob["G"])
        print(f"Loaded train state epoch {se}")
    else:
        print(f"WARNING: no checkpoint at {load_path}; using random init")
    return G


def generate_signals(save_path, data_path, load_path, config_file=None,
                     data_file="test_files", epoch=None, dataset_format="vctk",
                     crepe_weights=None, device=None):
    dev = resolve_device(device)
    save_path, data_path, load_path = Path(save_path), Path(data_path), Path(load_path)
    cfg = load_config(config_file if config_file else load_path / "config.yaml")
    save_path.mkdir(parents=True, exist_ok=True)

    test_ds = WaveDataset(
        data_path / data_file, data_path / "speakers",
        sample_rate=cfg.model.sample_rate, add_new_spks=True,
        normalization_db=cfg.train.normalization_db,
    )

    # speakers actually present in the manifest (generate_with_target.py:80-83)
    ds_spks = sorted({test_ds.spk_dict[label] for _, label in test_ds.entries})

    # per-speaker utterance cycles for target F0 statistics (:89-100,143-148)
    by_spk = {
        spk: [i for i, (_, label) in enumerate(test_ds.entries)
              if test_ds.spk_dict[label] == spk]
        for spk in ds_spks
    }
    spk_iters = {
        spk: itertools.cycle(np.random.default_rng(spk).permutation(idxs).tolist())
        for spk, idxs in by_spk.items()
    }

    G = load_generator(cfg, load_path, epoch, test_ds.num_spk, dev)
    if crepe_weights:
        from td_vc_gan_tpu_torch.training.torch_import import load_torchcrepe

        crepe = load_torchcrepe(crepe_weights)
    else:
        crepe = crepe_from_seed(0)
    conv = Converter(cfg, G, crepe, decoder="viterbi", device=dev)

    t0 = time.perf_counter()
    k0 = cc_mod.launches
    calls = 0
    audio_s = 0.0
    peak, finite = 0.0, True
    conv_log = []
    for i in range(len(test_ds)):
        item = test_ds.__getitem__(i)
        signal = item["signal"]
        label_src = int(item["label"])
        file_name = test_ds.get_filename(i)
        spk_src = test_ds.spk_reverse_dict[label_src]
        phrase_id = parse_fn(file_name, dataset_format)

        f0_src, mu_src = conv.pitch(signal)

        # the targets' pitch statistics, then the whole target grid of this
        # utterance in one batched call
        mu_tgts, tgt_files = [], []
        for tgt in ds_spks:
            tgt_idx = next(spk_iters[tgt])
            tgt_item = test_ds.__getitem__(tgt_idx)
            _, mu_tgt = conv.pitch(tgt_item["signal"])
            mu_tgts.append(mu_tgt[0])
            tgt_files.append(test_ds.get_filename(tgt_idx))

        padded, n = conv.pad_to_bucket(signal)
        b = len(ds_spks)
        wavs = conv.convert_batch(
            np.repeat(padded[None], b, axis=0),
            np.asarray(ds_spks, dtype=np.int32),
            np.repeat(f0_src, b, axis=0),
            np.repeat(mu_src, b, axis=0),
            np.stack(mu_tgts),
            seed=i,
        )[:, :n]
        calls += 1
        audio_s += b * n / cfg.model.sample_rate
        finite = finite and bool(np.isfinite(wavs).all())
        peak = max(peak, float(np.abs(wavs).max()))

        for j, tgt in enumerate(ds_spks):
            spk_tgt = test_ds.spk_reverse_dict[tgt]
            name = f"{phrase_id}-{spk_src}-{spk_tgt}-conv"
            write_audio(save_path / f"{name}.wav", wavs[j], cfg.model.sample_rate)
            conv_log.append(f"{name}|{file_name}|{tgt_files[j]}")

        write_audio(save_path / f"{phrase_id}-{spk_src}-X-orig.wav", signal,
                    cfg.model.sample_rate)
    (save_path / "conv_log.txt").write_text("\n".join(conv_log) + "\n")
    wall = time.perf_counter() - t0
    print(f"Converted {len(test_ds)} utterances to {len(ds_spks)} speakers in {calls} "
          f"convert_batch calls: {audio_s:.2f} s of audio in {wall:.2f} s "
          f"(RTF {audio_s / max(wall, 1e-9):.1f}x, file I/O and pitch included); "
          f"cond-chain K1 launches {cc_mod.launches - k0}; outputs "
          f"{'finite' if finite else 'NOT finite'}, max|y| {peak:.4f} before writing")


def main(argv=None):
    a = parse_args(argv)
    # f32 throughout, as the JAX package's default: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    generate_signals(a.save_path, a.data_path, a.load_path, a.config_file,
                     a.data_file, a.epoch, a.data_format, a.crepe_weights, a.device)


if __name__ == "__main__":
    main()
