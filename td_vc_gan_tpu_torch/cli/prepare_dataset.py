"""Train/test manifests and the speakers dict from per-speaker folders (the
reference's scripts/prepare_dataset.py).

The port's own copy of ``td_vc_gan_tpu/cli/prepare_dataset.py``, with the
same arguments and output: ``train_files`` and ``test_files`` (``path|speaker``
lines), the pickled ``speakers`` dict, and with ``--out_of_sample_speakers N``
``test_oos_files`` and ``speakers_oos``. A speaker with more than
``5 * test_size`` files gives its first ``test_size`` (sorted, or shuffled
with ``--test_random``) to the test manifest. Speakers are shuffled with
Python's global ``random`` before the out-of-sample ones are split off, as
the reference does; seed it to repeat a split.

Usage:
    python -m td_vc_gan_tpu_torch.cli.prepare_dataset DATASET_FOLDER \
        --save_folder data/vctk [--test_size 3] [--ext .wav]
"""

from __future__ import annotations

import argparse
import pickle
import random
from glob import glob
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset_folder")
    p.add_argument("--save_folder", default=".")
    p.add_argument("--test_size", type=int, default=3)
    p.add_argument("--max_tests_ratio", type=float, default=0.1)
    p.add_argument("--test_random", action="store_true")
    p.add_argument("--out_of_sample_speakers", type=int, default=0)
    p.add_argument("--ext", default=".npy")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    save = Path(opt.save_folder)
    save.mkdir(parents=True, exist_ok=True)
    root = Path(opt.dataset_folder)

    dirs = sorted(
        d.name for d in root.iterdir()
        if d.is_dir() and glob(str(d / "**" / f"*{opt.ext}"), recursive=True)
    )
    random.shuffle(dirs)
    dirs, dirs_oos = dirs[opt.out_of_sample_speakers:], dirs[:opt.out_of_sample_speakers]
    dirs.sort()
    print("Speakers:", dirs)
    if dirs_oos:
        print("Speakers out of sample:", dirs_oos)

    spks = {d: i for i, d in enumerate(dirs)}
    spks_oos = {d: len(dirs) + i for i, d in enumerate(dirs_oos)}
    train_set, test_set, oos_set = [], [], []

    for d in dirs:
        files = sorted(glob(str(root / d / "**" / f"*{opt.ext}"), recursive=True))
        print(d, len(files))
        if len(files) > 5 * opt.test_size:
            if opt.test_random:
                random.shuffle(files)
            test_set += [f"{f}|{d}\n" for f in files[:opt.test_size]]
            train_set += [f"{f}|{d}\n" for f in files[opt.test_size:]]
        else:
            train_set += [f"{f}|{d}\n" for f in files]

    for d in dirs_oos:
        files = sorted(glob(str(root / d / f"*{opt.ext}")))
        oos_set += [f"{f}|{d}\n" for f in files]

    (save / "train_files").write_text("".join(train_set))
    (save / "test_files").write_text("".join(test_set))
    with open(save / "speakers", "wb") as f:
        pickle.dump(spks, f)
    if oos_set:
        (save / "test_oos_files").write_text("".join(oos_set))
        with open(save / "speakers_oos", "wb") as f:
            pickle.dump(spks_oos, f)
    print(f"{len(train_set)} train and {len(test_set)} test files of {len(dirs)} speakers "
          f"-> {save}")


if __name__ == "__main__":
    main()
