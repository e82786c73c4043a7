"""Label-only conversion of a test manifest to every speaker in it (the
reference's generate_from_dataset.py:48-128).

Counterpart of ``td_vc_gan_tpu/cli/generate_from_dataset.py``, with the same
arguments plus ``--device``. No target F0 is matched: the reference passes
no excitation, which its decoder cannot run, so, as the JAX package does,
the decoder gets a zero excitation, whose F0 frame count is taken from the
utterance's length padded to the Converter's bucket; ``--use_source_pitch``
drives the excitation with the source's own F0 instead
(``Converter.convert_with_ratio`` at ratio 1). G comes from the run as
``generate_with_target`` loads it.

Outputs ``sig{i:02d}_{src}-{tgt}_conv.wav`` for every target speaker and
``sig{i:02d}_{src}-X_orig.wav`` in ``--save_path``.

Usage:
    python -m td_vc_gan_tpu_torch.cli.generate_from_dataset --save_path out \
        --load_path runs/exp --data_path data/vctk [--use_source_pitch] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.cli.generate_with_target import ConversionTally, load_crepe, load_generator
from td_vc_gan_tpu_torch.config import load_config
from td_vc_gan_tpu_torch.data.audio_io import write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset
from td_vc_gan_tpu_torch.inference import Converter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save_path", required=True)
    p.add_argument("--load_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--data_file", default="test_files")
    p.add_argument("--config_file", default=None)
    p.add_argument("--epoch", default=None)
    p.add_argument("--crepe_weights", default=None)
    p.add_argument("--use_source_pitch", action="store_true",
                   help="drive the excitation with the source F0 (ratio 1)")
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

    ds = WaveDataset(
        data_path / a.data_file, data_path / "speakers",
        sample_rate=cfg.model.sample_rate, add_new_spks=True,
        normalization_db=cfg.train.normalization_db,
    )
    ds_spks = sorted({ds.spk_dict[label] for _, label in ds.entries})
    G = load_generator(cfg, load_path, a.epoch, ds.num_spk, dev)
    conv = Converter(cfg, G, load_crepe(a.crepe_weights), device=dev)

    tally = ConversionTally(conv)
    for i in range(len(ds)):
        item = ds.__getitem__(i)
        signal = item["signal"]
        label_src = int(item["label"])
        for tgt in ds_spks:
            if a.use_source_pitch:
                wav = conv.convert_with_ratio(signal, tgt, 1.0, seed=i)
            else:
                # the F0 frames of the padded length the Converter runs at
                padded_len = -(-len(signal) // conv.bucket) * conv.bucket
                f0 = np.zeros((1, padded_len // 64 + 1), np.float32)
                wav = conv.convert(signal, tgt, f0, np.zeros((1, 1)), np.zeros((1, 1)), seed=i)
            tally.add(wav)
            write_audio(save_path / f"sig{i:02d}_{label_src}-{tgt}_conv.wav",
                        wav, cfg.model.sample_rate)
        write_audio(save_path / f"sig{i:02d}_{label_src}-X_orig.wav", signal,
                    cfg.model.sample_rate)
    pitch = "source pitch" if a.use_source_pitch else "zero excitation"
    print(tally.summary(f"{len(ds)} utterances to {len(ds_spks)} speakers ({pitch})",
                        "convert"))


if __name__ == "__main__":
    main()
