"""Predicted MOS: first-party CNN-BLSTM predictor + external-command hook.

The port's counterpart of ``td_vc_gan_tpu/eval/mosnet.py``; the predictor
runs on the device (the CUDA card unless the caller asks for the CPU).

The reference shells out to an external ../MOSNet clone in a separate conda
env (test_scripts/vctk/run_test.sh:26-30) — the model is not part of the
repo there either. Here the predictor is first-party
(``models/mosnet.py``, a CNN-BLSTM that loads the official Keras .h5
weights via ``--mosnet_ckpt``); the external-command hook
(``--mosnet_cmd``) is kept for drop-in use of the upstream clone. Either
path merges into the HTML/JSON report the same way.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path


def predict_mos_native(conv_dir: str | Path, checkpoint: str,
                       pattern: str = "*.wav", device=None) -> dict:
    """First-party MOS prediction over every wav in ``conv_dir``.

    checkpoint: Keras .h5 (official MOSNet weights) or .npz with this
    repo's slot names. Returns the same shape as :func:`predict_mos`.
    """
    from td_vc_gan_tpu_torch.data.audio_io import read_audio
    from td_vc_gan_tpu_torch.models import mosnet as mosnet_model

    predictor = mosnet_model.MOSPredictor(mosnet_model.load_mosnet(checkpoint), device)
    scores: dict = {}
    for f in sorted(Path(conv_dir).glob(pattern)):
        wav, sr = read_audio(f, mosnet_model.SR)
        scores[f.name] = predictor.score(wav, sr)
    vals = list(scores.values())
    return {
        "available": True,
        "backend": "native",
        "mean_mos": sum(vals) / len(vals) if vals else float("nan"),
        "n": len(vals),
        "scores": scores,
    }


def predict_mos(conv_dir: str | Path, command: str | None = None) -> dict:
    """Run an external MOS predictor over ``conv_dir``.

    command: shell template with ``{dir}`` placeholder, e.g.
    ``python ../MOSNet/custom_test.py --rootdir {dir}``. Output parsing:
    JSON object on stdout, else ``name score`` lines.
    Returns {"available": False} when no command is configured.
    """
    if not command:
        return {"available": False, "note": "pass --mosnet_cmd to enable"}
    out = subprocess.run(
        command.format(dir=str(conv_dir)), shell=True, capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    try:
        scores = json.loads(out)
    except json.JSONDecodeError:
        scores = {}
        for line in out.splitlines():
            parts = line.split()
            if len(parts) >= 2:
                try:
                    scores[parts[0]] = float(parts[-1])
                except ValueError:
                    continue
    vals = [v for v in scores.values() if isinstance(v, (int, float))]
    return {
        "available": True,
        "mean_mos": sum(vals) / len(vals) if vals else float("nan"),
        "n": len(vals),
        "scores": scores,
    }


def to_matrices(scores: dict, parse) -> dict:
    """{filename: score} -> reference-shaped result matrices
    (test_scripts/vctk/test_mosnet.py): ``mos_result_conv[src][tgt]`` lists
    plus ``mos_result_orig[spk]`` lists; consumable by the HTML builders."""
    import os

    out: dict = {"mos_result_conv": {}, "mos_result_orig": {}}
    for name, score in sorted(scores.items()):
        parsed = parse(os.path.basename(name))
        if parsed is None:
            continue
        _, src, tgt, kind = parsed
        if kind == "conv":
            out["mos_result_conv"].setdefault(src, {}).setdefault(tgt, []).append(score)
        elif kind == "orig":
            out["mos_result_orig"].setdefault(src, []).append(score)
        # other kinds (possible under a custom --parse_regex, e.g. 'ref'
        # wavs) are out of scope, matching scan_wavs — counting them as
        # originals would skew the MOS baseline
    return out
