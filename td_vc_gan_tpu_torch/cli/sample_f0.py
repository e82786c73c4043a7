"""F0 contours of converted/original pairs for checking pitch control (the
reference's test_scripts/sample_f0.py:41-114).

Counterpart of ``td_vc_gan_tpu/cli/sample_f0.py``, with ``--device``: for
every ``{phrase}-{src}-{tgt}-conv.wav`` in CONV_DIR with its
``{phrase}-{src}-X-orig.wav`` (as ``generate_with_target`` writes them),
CREPE with the Viterbi decoder gives both F0 contours on the device, and
the ratio of their voiced log-F0 means is written to
``CONV_DIR/f0_ratios.json`` (always), with both medians. ``--out`` also
draws a histogram of the ratios when matplotlib is installed.

Usage:
    python -m td_vc_gan_tpu_torch.cli.sample_f0 CONV_DIR [--out ratios.png] \
        [--crepe_weights full.pth] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.cli.generate_with_target import load_crepe
from td_vc_gan_tpu_torch.data.audio_io import read_audio
from td_vc_gan_tpu_torch.models import crepe as crepe_mod


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("conv_dir", help="directory of *-conv.wav / *-X-orig.wav files")
    p.add_argument("--out", default=None, help="output plot path (png); json always written")
    p.add_argument("--crepe_weights", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(a.device)
    conv_dir = Path(a.conv_dir)
    net = load_crepe(a.crepe_weights).to(dev).eval()

    @torch.inference_mode()
    def pitch(path):
        wav, _ = read_audio(path, 16000)
        n = len(wav) // 320 * 320
        x = torch.tensor(wav[:n], dtype=torch.float32, device=dev)[None]
        f0, _ = crepe_mod.filtered_pitch(net, x, "viterbi")
        return f0[0].cpu().numpy()

    conv_re = re.compile(r"(.+)-(.+)-(.+)-conv\.wav")
    results = {}
    for f in sorted(conv_dir.glob("*-conv.wav")):
        m = conv_re.match(f.name)
        if not m:
            continue
        phrase, src, tgt = m.groups()
        orig = conv_dir / f"{phrase}-{src}-X-orig.wav"
        if not orig.exists():
            continue
        f0_conv, f0_orig = pitch(f), pitch(orig)
        vc, vo = f0_conv[f0_conv > 0], f0_orig[f0_orig > 0]
        if vc.size and vo.size:
            ratio = float(np.exp(np.mean(np.log(vc)) - np.mean(np.log(vo))))
            results[f.name] = {"f0_ratio": ratio,
                               "conv_median": float(np.median(vc)),
                               "orig_median": float(np.median(vo))}
    out_json = conv_dir / "f0_ratios.json"
    out_json.write_text(json.dumps(results, indent=1))
    ratios = [r["f0_ratio"] for r in results.values()]
    print(f"{len(ratios)} pairs; ratio mean {np.mean(ratios):.3f} "
          f"median {np.median(ratios):.3f}" if ratios else "no pairs found")

    if a.out and ratios:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(6, 4))
            plt.hist(ratios, bins=30)
            plt.xlabel("achieved F0 ratio (conv/orig)")
            plt.ylabel("count")
            plt.savefig(a.out, dpi=120, bbox_inches="tight")
            print(f"plot: {a.out}")
        except ImportError:
            print("matplotlib unavailable; json written only")


if __name__ == "__main__":
    main()
