"""ASR intelligibility (WER/CER) of converted vs original speech.

Re-design of test_scripts/common/test_asr.py:34-120. Uses a local Whisper
checkpoint through transformers when a model path is supplied; nothing is
downloaded, so the metric degrades gracefully to 'unavailable' without one.

The port's counterpart of ``td_vc_gan_tpu/eval/asr.py``: transformers is
imported in ``Transcriber`` only, and its pipeline runs on the device (the
CUDA card unless the caller asks for the CPU), where the JAX package's runs
on the CPU; the pipeline's framework is left to transformers (torch).
"""

from __future__ import annotations

import numpy as np

from td_vc_gan_tpu_torch import resolve_device


def _levenshtein(a: list, b: list) -> int:
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev = dp[0]
        dp[0] = i
        for j, cb in enumerate(b, 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
            prev = cur
    return dp[-1]


def wer(ref: str, hyp: str) -> float:
    r, h = ref.lower().split(), hyp.lower().split()
    return _levenshtein(r, h) / max(len(r), 1)


def cer(ref: str, hyp: str) -> float:
    r, h = list(ref.lower()), list(hyp.lower())
    return _levenshtein(r, h) / max(len(r), 1)


class Transcriber:
    def __init__(self, model_path: str | None = None, sr: int = 16000, device=None):
        self.sr = sr
        self.pipe = None
        if model_path:
            from transformers import pipeline

            # no framework="pt" (the JAX package passes it): transformers 5
            # has no such argument and hands it to generate, which raises
            self.pipe = pipeline("automatic-speech-recognition", model=model_path,
                                 device=resolve_device(device))

    @property
    def available(self) -> bool:
        return self.pipe is not None

    def __call__(self, wav: np.ndarray) -> str:
        if self.pipe is None:
            raise RuntimeError("no ASR model available (pass --asr_model)")
        return self.pipe({"raw": wav.astype(np.float32), "sampling_rate": self.sr})["text"]


def evaluate(pairs, model_path: str | None = None, sr: int = 16000, device=None) -> dict:
    """pairs: list of (conv_wav, orig_wav) or (conv_wav, ref_text)."""
    t = Transcriber(model_path, sr, device)
    if not t.available:
        return {"available": False, "note": "supply a local whisper checkpoint"}
    wers, cers = [], []
    for conv, ref in pairs:
        ref_text = ref if isinstance(ref, str) else t(ref)
        hyp = t(conv)
        wers.append(wer(ref_text, hyp))
        cers.append(cer(ref_text, hyp))
    return {
        "available": True,
        "wer": float(np.mean(wers)),
        "cer": float(np.mean(cers)),
        "n": len(wers),
    }
