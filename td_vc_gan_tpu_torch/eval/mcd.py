"""Mel-cepstral distortion + F0 statistics, reference protocol.

Re-design of test_scripts/common/test_mcd.py:29-172 on top of the
first-party WORLD/SPTK analysis in eval/world.py (dio -> stonemask ->
cheaptrick -> sp2mc, 24-dim, alpha=0.42, 5 ms hop). Protocol parity:

- each ``{sig_id}-{src}-{tgt}-conv.wav`` is compared against the
  SAME-PHRASE target original ``{sig_id}-{tgt}-X-orig.wav``
  (test_mcd.py:146 — round-1 VERDICT missing #2);
- voiced-only frames, DTW alignment, score = path cost / path length with
  the reference's bare-euclidean convention (no dB constant);
- the orig-vs-orig baseline matrix over same-phrase original pairs
  (test_mcd.py:155-167), plus ``f0_ratio`` (conv vs SOURCE original) and
  ``f0_ratio_orig`` control;
- results pickled as nested ``{src: {tgt: [per-phrase]}}`` dicts with the
  reference's exact keys, consumable by the HTML builders.

Alignment uses an exact DTW instead of the reference's approximate
fastdtw(radius=1) — exact cost <= fastdtw cost, same units.

The port's counterpart of ``td_vc_gan_tpu/eval/mcd.py``: the same protocol
and pickles, on the port's copy of the WORLD analysis and its own DTW
(``eval/dtw.py``, identical in cost and path to the JAX package's C++ one).
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path

import numpy as np

from td_vc_gan_tpu_torch.eval import world
from td_vc_gan_tpu_torch.eval.dtw import dtw

SR = 16000


def parse_fn(filename: str):
    """``{sig_id}-{src}-{tgt}-{orig|conv}.wav`` -> groups (common/__init__.py)."""
    m = re.match(r"(\S+)-(\S+)-(\S+)-(orig|conv)\.wav", os.path.basename(filename))
    if m is None:
        return None
    return m.groups()


def scan_wavs(test_dir, parse):
    """Parse every wav in ``test_dir`` into field-keyed maps.

    Returns (origs, convs): ``origs[(sig_id, spk)] -> path`` for files whose
    parsed kind is 'orig' and ``convs[(sig_id, src, tgt)] -> path`` for
    'conv'. Files the parse_fn rejects (returns None) are skipped — under a
    custom --parse_regex the directory may hold foreign names.
    """
    origs: dict = {}
    convs: dict = {}
    for f in sorted(Path(test_dir).glob("*.wav")):
        parsed = parse(f.name)
        if parsed is None:
            continue
        sig_id, src, tgt, kind = parsed
        table = origs if kind == "orig" else convs if kind == "conv" else None
        if table is None:
            continue
        key = (sig_id, src) if kind == "orig" else (sig_id, src, tgt)
        if key in table:
            # a parse_fn whose groups don't uniquely identify files would
            # otherwise silently drop all but the last match
            import sys

            print(f"[scan_wavs] WARNING: {f.name} parses to the same key "
                  f"{key} as {table[key].name}; keeping only {f.name} — "
                  f"make the parse groups unique", file=sys.stderr)
        table[key] = f
    return origs, convs


def world_mcep(signal: np.ndarray, sr: int = SR):
    """(voiced-only mcep (n, 25), full f0 contour) — test_mcd.py:58-62."""
    mcep, f0 = world.world_analyze(signal, sr)
    return mcep[f0 > 0], f0


def mcd_from_mceps(test_mcep: np.ndarray, ref_mcep: np.ndarray) -> float:
    """DTW-aligned mean frame distance (reference's dist/len(path))."""
    if len(test_mcep) < 2 or len(ref_mcep) < 2:
        return float("nan")
    d2 = (
        np.sum(test_mcep**2, -1)[:, None]
        + np.sum(ref_mcep**2, -1)[None, :]
        - 2.0 * test_mcep @ ref_mcep.T
    )
    dist = np.sqrt(np.maximum(d2, 0.0)).astype(np.float32)
    total, path = dtw(dist)
    if len(path) == 0:
        return float("nan")
    return float(total / len(path))


def mfcc_dist(test, ref) -> tuple[float, float, float]:
    """(mcd, diff_logf0_mean, diff_logf0_var) between two analyses.

    test/ref: (voiced mcep, f0 contour) pairs from :func:`world_mcep` —
    mirrors test_mcd.py:54-93 including the <10-voiced-frames NaN guard.
    """
    test_mcep, test_f0 = test
    ref_mcep, ref_f0 = ref
    tv, rv = test_f0[test_f0 > 0], ref_f0[ref_f0 > 0]
    if tv.size < 10 or rv.size < 10:
        return float("nan"), float("nan"), float("nan")
    mcd = mcd_from_mceps(test_mcep, ref_mcep)
    diff_f0_mean = float(np.mean(np.log(tv)) - np.mean(np.log(rv)))
    diff_f0_var = float(np.log(np.var(tv)) - np.log(np.var(rv)))
    return mcd, diff_f0_mean, diff_f0_var


def f0_ratio(test, ref) -> float:
    """mean(ref_f0)/mean(test_f0) — test_mcd.py:95-122's orientation."""
    _, test_f0 = test
    _, ref_f0 = ref
    tv, rv = test_f0[test_f0 > 0], ref_f0[ref_f0 > 0]
    if tv.size < 3 or rv.size < 3:
        return float("nan")
    return float(np.mean(rv) / np.mean(tv))


class _AnalysisCache:
    """Per-run memo of world analyses keyed by path (ref_mceps in test_mcd)."""

    def __init__(self, sr: int = SR):
        self.sr = sr
        self._memo: dict = {}

    def __call__(self, path):
        key = str(path)
        if key not in self._memo:
            from td_vc_gan_tpu_torch.data.audio_io import read_audio

            signal, _ = read_audio(path, self.sr)
            self._memo[key] = world_mcep(signal, self.sr)
        return self._memo[key]


def test_mcd(out_filename, test_dir, parse=None, sr: int = SR) -> dict:
    """Directory protocol of test_mcd.py:128-172; returns + pickles results.

    Keys: mcd_result_conv, mcd_result_orig, diff_f0_mean, diff_f0_var,
    f0_ratio, f0_ratio_orig — each ``{src: {tgt: [values]}}``.
    """
    parse = parse or parse_fn
    test_dir = Path(test_dir)
    analyze = _AnalysisCache(sr)

    # Field-based enumeration: parse every wav once and match pairs by the
    # parsed (sig_id, spk, kind) fields — reconstructing filenames from the
    # fields would silently find nothing under a custom --parse_regex whose
    # naming differs from this build's default. Non-matching files are
    # skipped, like the reference's per-dataset parse_fns.
    origs, convs = scan_wavs(test_dir, parse)
    results: dict = {
        "mcd_result_conv": {}, "mcd_result_orig": {},
        "diff_f0_mean": {}, "diff_f0_var": {},
        "f0_ratio": {}, "f0_ratio_orig": {},
    }

    def push(key, src, tgt, value):
        results[key].setdefault(src, {}).setdefault(tgt, []).append(value)

    for (sig_id, src_spk, tgt_spk), conv_file in sorted(convs.items()):
        src_file = origs.get((sig_id, src_spk))
        tgt_file = origs.get((sig_id, tgt_spk))
        if tgt_file is None:
            # VCTK phrase ids name their speaker (p225_003 converted to p226
            # pairs with p226_003): the original reference rewrites the
            # phrase, re.sub(src_spk, tgt_spk, ...) (vctk/test_mcd.py:152)
            tgt_file = origs.get((re.sub(re.escape(src_spk), tgt_spk, sig_id), tgt_spk))
        if src_file is None or tgt_file is None:
            continue
        conv_a = analyze(conv_file)
        mcd, dmean, dvar = mfcc_dist(conv_a, analyze(tgt_file))
        push("mcd_result_conv", src_spk, tgt_spk, mcd)
        push("diff_f0_mean", src_spk, tgt_spk, dmean)
        push("diff_f0_var", src_spk, tgt_spk, dvar)
        push("f0_ratio", src_spk, tgt_spk, f0_ratio(conv_a, analyze(src_file)))

    # orig-vs-orig baseline over same-phrase pairs (test_mcd.py:155-167)
    for (sig_id, src_spk), src_file in sorted(origs.items()):
        for (sig_id_tgt, tgt_spk), tgt_file in sorted(origs.items()):
            if sig_id != sig_id_tgt:
                continue
            mcd, _, _ = mfcc_dist(analyze(src_file), analyze(tgt_file))
            push("mcd_result_orig", src_spk, tgt_spk, mcd)
            push("f0_ratio_orig", src_spk, tgt_spk,
                 f0_ratio(analyze(tgt_file), analyze(src_file)))

    if out_filename is not None:
        with open(out_filename, "wb") as f:
            pickle.dump(results, f)
    return results


# ---------------------------------------------------------------------------
# direct two-signal API (kept for library users / tests)
# ---------------------------------------------------------------------------


def compute_mcd(conv: np.ndarray, target: np.ndarray, sr: int = SR) -> dict:
    """MCD + F0 statistics between two in-memory utterances."""
    conv_a = world_mcep(conv, sr)
    tgt_a = world_mcep(target, sr)
    mcd, dmean, dvar = mfcc_dist(conv_a, tgt_a)
    out = {"mcd": mcd, "diff_logf0_mean": dmean, "diff_logf0_var": dvar,
           "logf0_mean_err": abs(dmean) if np.isfinite(dmean) else float("nan")}
    out["f0_ratio"] = 1.0 / f0_ratio(conv_a, tgt_a) if np.isfinite(
        f0_ratio(conv_a, tgt_a)) else float("nan")  # conv/target orientation
    return out
