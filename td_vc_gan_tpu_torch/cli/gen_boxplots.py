"""Cross-system comparison boxplots (reference: test_scripts/gen_boxplots.py:41-51):
aggregate metric JSONs from several systems (ours + baselines like AdaIN-VC,
AutoVC, FragmentVC, YourTTS) into MCD / similarity boxplots.

The port's copy of ``td_vc_gan_tpu/cli/gen_boxplots.py`` (host only; it
reads the ``index.json`` that ``run_test`` writes).

Usage:
    python -m td_vc_gan_tpu_torch.cli.gen_boxplots ours=out/index.json \
        other=base/index.json [--out boxplots.png]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results", nargs="+",
                   help="name=path pairs; path is a run_test index.json")
    p.add_argument("--out", default="boxplots.png")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    systems = {}
    for item in a.results:
        name, _, path = item.partition("=")
        data = json.loads(Path(path).read_text())
        mcds = [r["mcd"] for r in data.get("mcd", {}).values()
                if isinstance(r.get("mcd"), (int, float)) and np.isfinite(r["mcd"])]
        systems[name] = mcds
        print(f"{name}: n={len(mcds)} mcd median={np.median(mcds):.2f}" if mcds else f"{name}: no data")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(1.5 * len(systems) + 2, 4))
        plt.boxplot([systems[k] for k in systems], tick_labels=list(systems))
        plt.ylabel("MCD (dB)")
        plt.savefig(a.out, dpi=120, bbox_inches="tight")
        print(f"plot: {a.out}")
    except ImportError:
        print("matplotlib unavailable; stats printed only")


if __name__ == "__main__":
    main()
