"""Per-dataset evaluation presets (reference: ``test_scripts/{vctk,cmu_arctic,mls-pt}/``).

The port's own copy of ``td_vc_gan_tpu/eval/presets.py``, unchanged in
behaviour.

The reference ships three tuned copies of the eval harness, one directory per
dataset, differing in exactly two dataset-specific ways:

1. the filename ``parse_fn`` regexes that map generated wav names back to
   (signal id, source speaker, target speaker, orig|conv) — e.g.
   test_scripts/vctk/test_mcd.py:143-150, cmu_arctic/test_mcd.py:108-115,
   mls-pt/test_gen_html.py:292;
2. the ``run_test.sh`` recipe: which metric stages the dataset's harness runs
   (vctk/run_test.sh:15-35 runs the full chain; cmu_arctic/run_test.sh keeps
   only MCD + MOSNet + HTML with speaker-rec commented out; mls-pt/run_test.sh
   runs only speaker-rec + HTML — it ships no test_mcd.py at all).

This build centralizes both per-dataset facts here instead of copying the
harness three times. Every preset parse_fn accepts BOTH naming schemes:

- this build's native ``{sig}-{src}-{tgt}-{orig|conv}.wav`` (what
  cli/generate_with_target.py writes), and
- the reference's per-dataset layout (``{phrase}_{src}-{tgt}_conv.wav``
  family), so wav directories produced by the reference's own generate
  scripts evaluate unchanged.

The two schemes cannot collide: the native regex requires a ``-orig.wav`` /
``-conv.wav`` suffix while every reference layout uses ``_orig.wav`` /
``_conv.wav``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

# all metric stages run_test.py knows how to run, in recipe order
ALL_STAGES = ("mcd", "spkrec", "mosnet", "asr", "info", "html")

_NATIVE = re.compile(r"(\S+)-(\S+)-(\S+)-(orig|conv)\.wav")
# reference generic layout (test_scripts/vctk/test_mcd.py:143 +
# test_speaker_rec.py:170; mls-pt reuses it verbatim): orig files are
# {phrase}_{src}-X_orig.wav, conversions {phrase}_{src}-{tgt}_conv.wav
_REF_GENERIC = re.compile(r"(\S+)_(\S+?)-(\S+?|X)_(conv|orig)\.wav")
# cmu_arctic wraps speaker names as cmu_us_{spk}_arctic and ends conversions
# with _conv.wav after the *wrapped* target (cmu_arctic/test_mcd.py:108-115)
_REF_CMU_CONV = re.compile(r"(\S+)_cmu_us_(\S+?)_arctic-cmu_us_(\S+?)_arctic_conv\.wav")
_REF_CMU_ORIG = re.compile(r"(\S+)_cmu_us_(\S+?)_arctic-X_orig\.wav")


def _native(filename: str):
    m = _NATIVE.match(os.path.basename(filename))
    return m.groups() if m else None


def parse_vctk(filename: str):
    """VCTK names: ``p225_003_p225-p226_conv.wav`` (test_gen_html.py:479-480)."""
    got = _native(filename)
    if got is not None:
        return got
    m = _REF_GENERIC.match(os.path.basename(filename))
    return m.groups() if m else None


def parse_cmu_arctic(filename: str):
    """CMU-Arctic names: ``arctic_a0001_cmu_us_bdl_arctic-cmu_us_slt_arctic_conv.wav``.

    The wrapped ``cmu_us_{spk}_arctic`` speaker ids are UNWRAPPED to the bare
    voice name (bdl/slt/...), exactly like the reference regexes capture them,
    so MCD/speaker-rec keys pair across orig and conv files.
    """
    got = _native(filename)
    if got is not None:
        return got
    base = os.path.basename(filename)
    m = _REF_CMU_CONV.match(base)
    if m is not None:
        return (*m.groups(), "conv")
    m = _REF_CMU_ORIG.match(base)
    if m is not None:
        return (m.group(1), m.group(2), "X", "orig")
    return None


def parse_mls_pt(filename: str):
    """MLS-pt names: numeric speakers, ``{spk}_{a}_{b}_{spk}-X_orig.wav``
    (mls-pt/test_gen_html.py:292; metric scripts reuse the generic layout)."""
    got = _native(filename)
    if got is not None:
        return got
    m = _REF_GENERIC.match(os.path.basename(filename))
    return m.groups() if m else None


@dataclass(frozen=True)
class EvalPreset:
    """One dataset's harness variant: its parse_fn + its recipe's stages."""

    name: str
    parse: callable
    stages: tuple

    def has(self, stage: str) -> bool:
        return stage in self.stages


PRESETS = {
    # full chain: generate -> MCD -> speaker-rec -> MOSNet -> info -> HTML
    # (vctk/run_test.sh:15-35); ASR via test_scripts/test_vctk.py:34
    "vctk": EvalPreset("vctk", parse_vctk, ALL_STAGES),
    # cmu_arctic/run_test.sh keeps MCD + MOSNet + HTML; speaker-rec and
    # get_model_info are commented out in the reference recipe
    "cmu_arctic": EvalPreset("cmu_arctic", parse_cmu_arctic,
                             ("mcd", "mosnet", "html")),
    # mls-pt/run_test.sh runs speaker-rec + HTML only (no test_mcd.py in the
    # reference's mls-pt directory); info/model-copy stages kept there too
    "mls-pt": EvalPreset("mls-pt", parse_mls_pt, ("spkrec", "info", "html")),
}
# underscore alias so shells that dislike '-' in values still hit the preset
PRESETS["mls_pt"] = PRESETS["mls-pt"]


def get(data_format: str) -> EvalPreset | None:
    """Preset for ``data_format``, or None for non-preset formats
    (plain/alcaim/smt run every stage with the native parse_fn)."""
    return PRESETS.get(data_format)
