"""Full evaluation orchestrator (reference: test_scripts/*/run_test.sh).

Chain, mirroring the reference stage for stage:
1. generate conversions into ``<save_path>/signals/`` (every test utterance
   x every speaker, ``{phrase}-{src}-{tgt}-conv.wav`` + originals);
2. MCD + F0 protocol (eval/mcd.test_mcd: same-phrase targets, orig-vs-orig
   baseline) -> ``mcd_results`` pickle;
3. speaker similarity (eval/speaker_rec.test_speaker_rec; ECAPA backend with
   ``--ecapa_checkpoint``) -> ``spkrec_results`` pickle;
4. optional external MOS predictor -> ``mosnet_results`` pickle;
5. optional ASR WER/CER with a local whisper checkpoint -> ``asr_results``;
6. model info + HTML/JSON report (parallel or nonparallel layout).

Counterpart of ``td_vc_gan_tpu/cli/run_test.py``, with the same arguments
plus ``--device``: generation (``cli/generate_with_target.generate_signals``,
K1 on the card), ECAPA, MOSNet and Whisper run on the device (the CUDA card
unless ``--device cpu``); WORLD, the DTW and the report on the host.

Usage:
    python -m td_vc_gan_tpu_torch.cli.run_test --save_path out --load_path runs/exp \
        --data_path data/vctk [--ecapa_checkpoint embedding_model.ckpt] \
        [--mosnet_ckpt mosnet.npz] [--asr_model whisper_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from td_vc_gan_tpu_torch.cli import generate_with_target as gwt
from td_vc_gan_tpu_torch.cli.get_model_info import estimate_train_time
from td_vc_gan_tpu_torch.data.audio_io import read_audio
from td_vc_gan_tpu_torch.eval import asr as asr_mod
from td_vc_gan_tpu_torch.eval import mcd as mcd_mod
from td_vc_gan_tpu_torch.eval import mosnet
from td_vc_gan_tpu_torch.eval import presets as presets_mod
from td_vc_gan_tpu_torch.eval import report as report_mod
from td_vc_gan_tpu_torch.eval import speaker_rec
from td_vc_gan_tpu_torch.eval.mcd import parse_fn as default_parse
from td_vc_gan_tpu_torch.eval.mcd import scan_wavs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save_path", required=True, help="output dir for conversions + report")
    p.add_argument("--load_path", required=True, help="checkpoint dir")
    p.add_argument("--data_path", required=True)
    p.add_argument("--data_file", default="test_files")
    p.add_argument("--config_file", default=None)
    p.add_argument("--epoch", default=None)
    p.add_argument("--data_format", default="vctk",
                   help="dataset preset: vctk/cmu_arctic/mls-pt select the "
                        "reference's per-dataset harness variant (parse_fn "
                        "regexes + run_test.sh stage recipe, see "
                        "eval/presets.py); other values (plain/alcaim/smt) "
                        "run every stage with the native parse_fn")
    p.add_argument("--stages", default=None,
                   help="comma list overriding the preset's stage recipe "
                        f"(any of {','.join(presets_mod.ALL_STAGES)})")
    p.add_argument("--report_layout", default="parallel",
                   choices=["parallel", "nonparallel"])
    p.add_argument("--asr_model", default=None, help="local whisper checkpoint dir")
    p.add_argument("--mosnet_cmd", default=None,
                   help="external MOS predictor command with {dir} placeholder")
    p.add_argument("--mosnet_ckpt", default=None,
                   help="first-party MOSNet weights (.h5 Keras or .npz)")
    p.add_argument("--ecapa_checkpoint", default=None,
                   help="speechbrain ECAPA embedding_model.ckpt for speaker rec")
    p.add_argument("--crepe_weights", default=None)
    p.add_argument("--parse_regex", default=None,
                   help="custom filename regex with 4 groups (sig_id, src, "
                        "tgt, kind) for wavs produced by other tools — "
                        "the reference ships per-dataset parse_fns "
                        "(test_scripts/vctk/test_gen_html.py); default "
                        "matches this build's {sig}-{src}-{tgt}-{kind}.wav. "
                        "The harness enumerates every *.wav and matches "
                        "pairs by the PARSED fields; unparseable files are "
                        "skipped. Group 4 must yield 'orig'/'conv', either "
                        "literally or via --parse_kind_map")
    p.add_argument("--parse_kind_map", default=None,
                   help="comma-separated mapping of the regex's kind group "
                        "to orig/conv, e.g. 'src=orig,gen=conv' — needed "
                        "when foreign filenames use different kind markers")
    p.add_argument("--skip_generate", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def make_parse_fn(regex: str, kind_map: str | None = None):
    """Build a parse_fn from a user regex with exactly 4 capture groups
    (sig_id, src, tgt, kind); returns None on non-matching filenames like
    the default (eval/mcd.parse_fn).

    ``kind_map`` ('src=orig,gen=conv') translates the regex's raw kind
    group to the harness's 'orig'/'conv' — a pure regex cannot rename its
    match, so foreign kind markers would otherwise never pair up."""
    import os
    import re

    pat = re.compile(regex)
    if pat.groups != 4:
        raise ValueError(
            f"--parse_regex needs exactly 4 capture groups "
            f"(sig_id, src, tgt, kind); got {pat.groups}")
    kmap = {}
    if kind_map:
        for item in kind_map.split(","):
            raw, _, mapped = item.partition("=")
            if mapped not in ("orig", "conv"):
                raise ValueError(
                    f"--parse_kind_map values must be orig or conv; got "
                    f"{item!r}")
            kmap[raw.strip()] = mapped

    def parse(filename: str):
        m = pat.match(os.path.basename(filename))
        if m is None:
            return None
        sig_id, src, tgt, kind = m.groups()
        return sig_id, src, tgt, kmap.get(kind, kind)

    return parse


def main(argv=None):
    a = parse_args(argv)
    # f32 throughout, as the JAX package's default: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    preset = presets_mod.get(a.data_format)
    if a.parse_regex:
        parse_fn = make_parse_fn(a.parse_regex, a.parse_kind_map)
    elif preset is not None:
        parse_fn = preset.parse
    else:
        parse_fn = default_parse
    if a.stages:
        stages = {s.strip() for s in a.stages.split(",") if s.strip()}
        unknown = stages - set(presets_mod.ALL_STAGES)
        if unknown:
            raise SystemExit(f"--stages: unknown stage(s) {sorted(unknown)}; "
                             f"choose from {','.join(presets_mod.ALL_STAGES)}")
    elif preset is not None:
        stages = set(preset.stages)
    else:
        stages = set(presets_mod.ALL_STAGES)
    save = Path(a.save_path)
    signals = save / "signals"
    if a.skip_generate and not signals.is_dir() and any(save.glob("*.wav")):
        signals = save  # legacy layout: wavs directly in save_path

    if not a.skip_generate:
        gwt.generate_signals(signals, a.data_path, a.load_path, a.config_file,
                             a.data_file, a.epoch, a.data_format, a.crepe_weights, a.device)

    mcd_results = None
    if "mcd" in stages:
        print("Computing MCD (WORLD mcep, same-phrase + orig baseline) ...")
        mcd_results = mcd_mod.test_mcd(save / "mcd_results", signals, parse=parse_fn)

    if "spkrec" in stages:
        print("Computing speaker similarity ...")
        spk_results = speaker_rec.test_speaker_rec(
            save / "spkrec_results", signals, parse=parse_fn,
            ecapa_checkpoint=a.ecapa_checkpoint, device=a.device)
        print(f"  backend: {spk_results['backend']}")

    if "mosnet" in stages and (a.mosnet_cmd or a.mosnet_ckpt):
        print("Computing MOS ...")
        raw = (mosnet.predict_mos_native(signals, a.mosnet_ckpt, device=a.device)
               if a.mosnet_ckpt else mosnet.predict_mos(signals, a.mosnet_cmd))
        if raw.get("available"):
            with open(save / "mosnet_results", "wb") as f:
                pickle.dump(mosnet.to_matrices(raw["scores"], parse_fn), f)
            print(f"  mean MOS: {raw.get('mean_mos'):.3f}")

    if "asr" in stages and a.asr_model:
        print("Computing ASR metrics ...")
        t = asr_mod.Transcriber(a.asr_model, device=a.device)
        wers: dict = {}
        cers: dict = {}
        orig_text: dict = {}
        origs, convs = scan_wavs(signals, parse_fn)
        for (sig_id, spk), f in sorted(origs.items()):
            wav, _ = read_audio(f, 16000)
            orig_text[(sig_id, spk)] = t(wav)
        for (sig_id, src, tgt), f in sorted(convs.items()):
            ref = orig_text.get((sig_id, src))
            if ref is None:
                continue
            wav, _ = read_audio(f, 16000)
            hyp = t(wav)
            wers.setdefault(src, {}).setdefault(tgt, []).append(asr_mod.wer(ref, hyp))
            cers.setdefault(src, {}).setdefault(tgt, []).append(asr_mod.cer(ref, hyp))
        flat_w = [v for row in wers.values() for vs in row.values() for v in vs]
        flat_c = [v for row in cers.values() for vs in row.values() for v in vs]
        asr_results = {
            "asr_results_wer": float(np.mean(flat_w)) if flat_w else float("nan"),
            "asr_results_cer": float(np.mean(flat_c)) if flat_c else float("nan"),
            "asr_results_wer_pair": report_mod.dict_stats_per_pair(wers),
            "asr_results_cer_pair": report_mod.dict_stats_per_pair(cers),
        }
        with open(save / "asr_results", "wb") as f:
            pickle.dump(asr_results, f)

    # model info sidecar (reference get_model_info stage)
    if "info" in stages:
        with open(save / "info", "wb") as f:
            pickle.dump(estimate_train_time(a.load_path), f)

    if "html" in stages:
        build = (report_mod.build_html_parallel if a.report_layout == "parallel"
                 else report_mod.build_html_nonparallel)
        out = build(save / "index.html", save, parse=parse_fn)
        print(f"Report: {out}")

    if mcd_results is not None:
        vals = [v for v in report_mod._flatten(mcd_results["mcd_result_conv"])]
        base = [v for v in report_mod._flatten(mcd_results["mcd_result_orig"])]
        if vals:
            print(f"MCD conv-vs-target mean: {np.mean(vals):.3f} over {len(vals)}"
                  + (f" (orig baseline {np.mean(base):.3f})" if base else ""))


if __name__ == "__main__":
    main()
