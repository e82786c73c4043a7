"""A manifest subset of speakers x utterances from an existing dataset (the
reference's test_scripts/vctk/generate_dataset_subset.py).

The port's own copy of ``td_vc_gan_tpu/cli/subset_dataset.py``: the same
``random.Random(seed)`` draws, so both packages pick the same subset.

Usage:
    python -m td_vc_gan_tpu_torch.cli.subset_dataset DATA_PATH OUT_PATH \
        [--num_speakers N] [--utts_per_speaker M] [--manifest test_files] [--seed 0]
"""

from __future__ import annotations

import argparse
import pickle
import random
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_path", help="dir with train_files/test_files/speakers")
    p.add_argument("out_path")
    p.add_argument("--num_speakers", type=int, default=None)
    p.add_argument("--utts_per_speaker", type=int, default=None)
    p.add_argument("--manifest", default="test_files")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    src, out = Path(a.data_path), Path(a.out_path)
    out.mkdir(parents=True, exist_ok=True)
    rng = random.Random(a.seed)

    entries = [line.split("|") for line in (src / a.manifest).read_text().splitlines() if line]
    by_spk: dict = {}
    for path, spk in entries:
        by_spk.setdefault(spk, []).append(path)

    speakers = sorted(by_spk)
    if a.num_speakers:
        speakers = rng.sample(speakers, min(a.num_speakers, len(speakers)))

    lines = []
    for spk in speakers:
        utts = sorted(by_spk[spk])
        if a.utts_per_speaker:
            utts = rng.sample(utts, min(a.utts_per_speaker, len(utts)))
        lines += [f"{u}|{spk}" for u in sorted(utts)]
    (out / a.manifest).write_text("\n".join(lines) + "\n")

    with open(src / "speakers", "rb") as f:
        spk_dict = pickle.load(f)
    with open(out / "speakers", "wb") as f:
        pickle.dump(spk_dict, f)
    print(f"{len(speakers)} speakers, {len(lines)} utterances -> {out / a.manifest}")


if __name__ == "__main__":
    main()
