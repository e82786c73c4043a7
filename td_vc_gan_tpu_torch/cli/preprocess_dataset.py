"""Offline RMS normalization of a per-speaker WAV tree, dropping signals
with NaNs (the reference's scripts/preprocess_dataset.py).

The port's own copy of ``td_vc_gan_tpu/cli/preprocess_dataset.py``: every
``*.wav`` under each speaker folder is read, scaled to
``--normalization_db`` dBFS RMS (``ops.dsp.eq_rms``) and written as 16-bit
PCM under ``--save_folder`` (default: in place) at the same relative path.

Usage:
    python -m td_vc_gan_tpu_torch.cli.preprocess_dataset DATASET_FOLDER \
        [--save_folder OUT] [--normalization_db -27]
"""

from __future__ import annotations

import argparse
from glob import glob
from pathlib import Path

import numpy as np

from td_vc_gan_tpu_torch.data.audio_io import read_audio, write_audio
from td_vc_gan_tpu_torch.ops.dsp import eq_rms


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset_folder")
    p.add_argument("--save_folder", default="")
    p.add_argument("--normalization_db", type=float)
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    root = Path(opt.dataset_folder)
    save = Path(opt.save_folder) if opt.save_folder else root
    save.mkdir(parents=True, exist_ok=True)

    dirs = sorted(
        d.name for d in root.iterdir()
        if d.is_dir() and glob(str(d / "**" / "*.wav"), recursive=True)
    )
    print("Speakers:", dirs)
    written = dropped = 0
    for d in dirs:
        out_dir = save / d
        out_dir.mkdir(parents=True, exist_ok=True)
        for file in sorted(glob(str(root / d / "**" / "*.wav"), recursive=True)):
            signal, sr = read_audio(file)
            if opt.normalization_db is not None:
                signal = eq_rms(signal, opt.normalization_db)
            if np.isnan(signal).any():
                dropped += 1
                continue
            write_audio(str(file).replace(str(root / d), str(out_dir)), signal, sr)
            written += 1
    print(f"{written} files written, {dropped} dropped (NaN) -> {save}")


if __name__ == "__main__":
    main()
