"""Render corruption variants offline, so that training reads them instead of
corrupting every item on the host.

The port's own copy of ``td_vc_gan_tpu/cli/precorrupt_dataset.py`` (no
reference equivalent: the reference corrupts inline). Each utterance of the
manifest is read, RMS-normalized to ``--normalization_db`` (which must match
the training config's), and corrupted ``--variants`` times by
``data.corruption.corrupt`` (TD-PSOLA formant and pitch warp, random EQ),
variant ``v`` of item ``i`` from ``SeedSequence([seed, i, v])``, as the JAX
package seeds it, so both packages render the same variants. The port's
``WaveDataset(precorrupted_index=...)`` (the train CLI's
``--precorrupted_index``) then replays each item's gain, flip and crop on a
stored variant chosen at random.

The corruption's PSOLA walk is a Python loop that holds the interpreter
lock, so the items are rendered in ``--workers`` processes (the JAX CLI
uses threads); ``--workers 1`` renders in this process.

Writes OUT/{item_idx:06d}_<stem>__c{k}.wav for every manifest entry (the
index prefix keeps variants apart when stems repeat across speaker folders)
and OUT/precorrupt_index.pkl, which maps each manifest path to its variants.

Usage:
    python -m td_vc_gan_tpu_torch.cli.precorrupt_dataset DATASET_FILE \
        --save_folder OUT [--variants 4] [--normalization_db -27] \
        [--sample_rate 16000] [--workers 8] [--seed 1234]
"""

from __future__ import annotations

import argparse
import multiprocessing
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from td_vc_gan_tpu_torch.data import corruption
from td_vc_gan_tpu_torch.data.audio_io import read_audio, write_audio
from td_vc_gan_tpu_torch.ops.dsp import eq_rms


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset_file", help="path|speaker manifest")
    p.add_argument("--save_folder", required=True)
    p.add_argument("--variants", type=int, default=4)
    p.add_argument("--normalization_db", type=float, default=None,
                   help="must match the training config's normalization_db")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=1234)
    return p.parse_args(argv)


def render(path: str, out_dir: Path, k: int, sr: int, norm_db: float | None, seed: int,
           item_idx: int) -> list[str]:
    """The ``k`` corruption variants of one utterance, written; their paths."""
    signal, _ = read_audio(path, sr)
    if norm_db:
        signal = eq_rms(signal, norm_db)
    outs = []
    for v in range(k):
        rng = np.random.default_rng(np.random.SeedSequence([seed, item_idx, v]))
        out = out_dir / f"{item_idx:06d}_{Path(path).stem}__c{v}.wav"
        write_audio(out, corruption.corrupt(signal, sr, rng), sr)
        outs.append(str(out))
    return outs


def main(argv=None) -> Path:
    args = parse_args(argv)
    out_dir = Path(args.save_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(args.dataset_file) as f:
        entries = [line.strip().split("|") for line in f if line.strip()]

    t0 = time.perf_counter()
    jobs = [(path, out_dir, args.variants, args.sample_rate, args.normalization_db, args.seed, i)
            for i, (path, _label) in enumerate(entries)]
    if args.workers <= 1:
        rendered = [render(*job) for job in jobs]
    else:
        # forked from a fork server, not from a caller that may hold CUDA
        # and threads
        ctx = multiprocessing.get_context("forkserver")
        with ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
            rendered = list(pool.map(render, *zip(*jobs)))
    index = {path: outs for (path, _label), outs in zip(entries, rendered)}

    index_path = out_dir / "precorrupt_index.pkl"
    with open(index_path, "wb") as f:
        pickle.dump(index, f)
    print(f"precorrupted {len(index)} utterances x {args.variants} variants in "
          f"{time.perf_counter() - t0:.1f} s with {max(args.workers, 1)} worker(s) "
          f"-> {index_path}")
    return index_path


if __name__ == "__main__":
    main()
