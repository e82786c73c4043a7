"""Concatenate dataset manifests, offsetting each source's speaker ids past
the ones before it (the reference's scripts/merge_datasets.py).

The port's own copy of ``td_vc_gan_tpu/cli/merge_datasets.py``.

Usage:
    python -m td_vc_gan_tpu_torch.cli.merge_datasets SRC_A SRC_B TARGET \
        [--root_folder .]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source_datasets", nargs="+")
    p.add_argument("target_dataset")
    p.add_argument("--root_folder", default=".")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    root = Path(args.root_folder)
    target = root / args.target_dataset
    target.mkdir(parents=True, exist_ok=True)

    for fn in ("train_files", "test_files"):
        lines = []
        for src in args.source_datasets:
            lines += (root / src / fn).read_text().splitlines(keepends=True)
        (target / fn).write_text("".join(lines))

    speakers: dict = {}
    offset = 0
    for src in args.source_datasets:
        with open(root / src / "speakers", "rb") as f:
            src_spk = pickle.load(f)
        for spk, idx in src_spk.items():
            speakers[spk] = idx + offset
        offset = len(speakers)
    with open(target / "speakers", "wb") as f:
        pickle.dump(speakers, f)
    print(f"{len(args.source_datasets)} datasets, {len(speakers)} speakers -> {target}")


if __name__ == "__main__":
    main()
