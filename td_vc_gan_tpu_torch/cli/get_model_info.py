"""Training-time estimate from the checkpoints' modification times, with
z-score outlier rejection (the reference's test_scripts/get_model_info.py:18-38).

Counterpart of ``td_vc_gan_tpu/cli/get_model_info.py``: it reads the
``step{E}-G.pt`` files and the port's full train states
(``torch_state/epoch_{E}.pt``) where the JAX CLI reads ``orbax/epoch_{E}``,
and prints the same keys.

Usage:
    python -m td_vc_gan_tpu_torch.cli.get_model_info runs/exp
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
from pathlib import Path

import numpy as np

# training/checkpoint.py's STATE_DIR, named here so that this CLI starts
# without importing torch
STATE_DIR = "torch_state"


def estimate_train_time(ckpt_dir: str | Path, z_thresh: float = 2.0) -> dict:
    ckpt_dir = Path(ckpt_dir)
    steps = []
    for f in ckpt_dir.glob("step*-G.pt"):
        m = re.match(r"step(\d+)-G\.pt", f.name)
        if m:
            steps.append((int(m.group(1)), os.path.getmtime(f)))
    for f in (ckpt_dir / STATE_DIR).glob("epoch_*.pt"):
        steps.append((int(f.stem.split("_")[1]), os.path.getmtime(f)))
    steps.sort()
    if len(steps) < 2:
        return {"checkpoints": len(steps), "estimated_hours": None}

    epochs = np.array([s for s, _ in steps], dtype=float)
    times = np.array([t for _, t in steps])
    rates = np.diff(times) / np.maximum(np.diff(epochs), 1e-9)  # s/epoch
    if len(rates) > 2:
        z = (rates - rates.mean()) / (rates.std() + 1e-9)
        rates = rates[np.abs(z) < z_thresh]
    per_epoch = float(np.mean(rates)) if len(rates) else float("nan")
    total = per_epoch * (epochs[-1] - epochs[0])
    return {
        "checkpoints": len(steps),
        "epoch_range": (int(epochs[0]), int(epochs[-1])),
        "seconds_per_epoch": per_epoch,
        "estimated_hours": total / 3600.0,
        "last_checkpoint": datetime.datetime.fromtimestamp(times[-1]).isoformat(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt_dir")
    args = p.parse_args(argv)
    info = estimate_train_time(args.ckpt_dir)
    for k, v in info.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
