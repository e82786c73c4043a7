"""Conversion over explicit (source, target) pairs, with the argmax pitch
decoder (the reference's generate_from_list.py:39-115).

Counterpart of ``td_vc_gan_tpu/cli/generate_from_list.py``, with the same
arguments plus ``--device``. The pairs file holds
``conv_name|source_path|target_path`` lines (``data/pairs.py``); each pair
is one ``Converter.convert`` call, the source's F0 shifted to the target
utterance's voiced log-F0 mean, written as ``{conv_name}.wav``. G comes
from the run as ``generate_with_target`` loads it.

Usage:
    python -m td_vc_gan_tpu_torch.cli.generate_from_list --save_path out \
        --load_path runs/exp --data_path data/vctk [--pairs_file pairs] \
        [--data_file test_files] [--epoch N] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.cli.generate_with_target import ConversionTally, load_crepe, load_generator
from td_vc_gan_tpu_torch.config import load_config
from td_vc_gan_tpu_torch.data.audio_io import write_audio
from td_vc_gan_tpu_torch.data.pairs import PairsDataset
from td_vc_gan_tpu_torch.inference import Converter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save_path", required=True)
    p.add_argument("--load_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--pairs_file", default="pairs")
    p.add_argument("--data_file", default="test_files")
    p.add_argument("--config_file", default=None)
    p.add_argument("--epoch", default=None)
    p.add_argument("--crepe_weights", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    # f32 throughout, as the JAX package's default: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(a.device)
    save_path, data_path, load_path = Path(a.save_path), Path(a.data_path), Path(a.load_path)
    cfg = load_config(a.config_file if a.config_file else load_path / "config.yaml")
    save_path.mkdir(parents=True, exist_ok=True)

    ds = PairsDataset(
        data_path / a.pairs_file, data_path / a.data_file, data_path / "speakers",
        sample_rate=cfg.model.sample_rate,
        normalization_db=cfg.train.normalization_db, add_new_spks=True,
    )
    G = load_generator(cfg, load_path, a.epoch, ds.num_spk, dev)
    conv = Converter(cfg, G, load_crepe(a.crepe_weights), decoder="argmax", device=dev)

    tally = ConversionTally(conv)
    for i in range(len(ds)):
        item = ds.__getitem__(i)
        f0_src, mu_src = conv.pitch(item["source"])
        _, mu_tgt = conv.pitch(item["target"])
        wav = conv.convert(item["source"], int(item["target_label"]), f0_src, mu_src, mu_tgt,
                           seed=i)
        tally.add(wav)
        write_audio(save_path / f"{item['conv_name']}.wav", wav, cfg.model.sample_rate)
    print(tally.summary(f"{len(ds)} pairs", "convert"))


if __name__ == "__main__":
    main()
