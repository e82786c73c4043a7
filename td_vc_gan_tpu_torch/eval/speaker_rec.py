"""Speaker-similarity metrics for converted audio, reference protocol.

The port's counterpart of ``td_vc_gan_tpu/eval/speaker_rec.py``: the same
backends in the same order, pickles and keys; the embedders run on the
device (the CUDA card unless the caller asks for the CPU).

Re-design of test_scripts/common/test_speaker_rec.py:128-183: embed every
original and converted utterance, average the originals per speaker, then
report (a) the cosine similarity of each conversion against its target
speaker's mean embedding (``emb_dist``) and (b) nearest-mean classification
of every conversion (``test_class``) — results pickled with the reference's
exact keys for the HTML builders.

Embedding backends, best available first:
1. ECAPA-TDNN (models/ecapa.py) given a speechbrain
   checkpoint — the reference's speechbrain classifier equivalent
   (test_speaker_rec.py:32-96, sb_classifier_hparams.yaml);
2. resemblyzer d-vectors when that wheel is importable (the reference's
   scored path, test_speaker_rec.py:120-139);
3. a self-contained log-mel statistics embedding, keeping the harness
   runnable hermetically (smoke-quality only; the report labels it).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.data.audio_io import read_audio
from td_vc_gan_tpu_torch.eval.mcd import parse_fn as default_parse
from td_vc_gan_tpu_torch.eval.mcd import scan_wavs


def _mel_stat_embed(wav: np.ndarray, sr: int, device) -> np.ndarray:
    import torch

    from td_vc_gan_tpu_torch.ops.stft import melspectrogram

    x = torch.from_numpy(np.asarray(wav, np.float32)[None]).to(device)
    mel = melspectrogram(x, sr, 1024, 40)[0].cpu().numpy()
    logm = np.log(np.maximum(mel, 1e-8))
    energy = logm.mean(-1)
    active = logm[energy > energy.max() - 6.0] if (energy > energy.max() - 6.0).any() else logm
    delta = np.diff(active, axis=0) if len(active) > 1 else np.zeros_like(active)
    emb = np.concatenate([
        active.mean(0), active.std(0), delta.mean(0), delta.std(0),
    ])
    return emb / (np.linalg.norm(emb) + 1e-9)


class SpeakerEmbedder:
    """Utterance -> fixed-size speaker embedding; backend auto-selection."""

    def __init__(self, sr: int = 16000, ecapa_checkpoint: str | None = None, device=None):
        self.sr = sr
        self.device = resolve_device(device)
        self.backend = "mel_stats"
        self._enc = None
        self._ecapa = None
        if ecapa_checkpoint is not None:
            from td_vc_gan_tpu_torch.models.ecapa import EcapaEmbedder

            self._ecapa = EcapaEmbedder.from_speechbrain(ecapa_checkpoint, sr=sr,
                                                         device=self.device)
            self.backend = "ecapa"
            return
        try:
            from resemblyzer import VoiceEncoder  # type: ignore
        except ImportError:
            return
        self._enc = VoiceEncoder(device=self.device)
        self.backend = "resemblyzer"

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        if self._ecapa is not None:
            return self._ecapa.embed(wav)
        if self._enc is not None:
            return self._enc.embed_utterance(wav.astype(np.float32))
        return _mel_stat_embed(wav, self.sr, self.device)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def test_speaker_rec(out_filename, test_dir, parse=None, sr: int = 16000,
                     ecapa_checkpoint: str | None = None, device=None) -> dict:
    """Directory protocol of test_speaker_rec.py:128-183.

    Keys: ref_class/ref_emb (per source speaker), test_emb, emb_dist
    (cosine vs target-speaker mean, ``{src: {tgt: [...]}}``), test_class
    (nearest-mean euclidean classification, reference :175-181).
    """
    parse = parse or default_parse
    test_dir = Path(test_dir)
    embed = SpeakerEmbedder(sr, ecapa_checkpoint, device)

    results: dict = {"test_class": {}, "ref_class": {}, "emb_dist": {},
                     "test_emb": {}, "ref_emb": {}, "backend": embed.backend}

    # field-based enumeration (see eval/mcd.scan_wavs): robust to custom
    # --parse_regex naming; unparseable files are skipped
    origs, convs = scan_wavs(test_dir, parse)
    for (sig_id, src_spk), src_file in sorted(origs.items()):
        wav, _ = read_audio(src_file, sr)
        results["ref_class"].setdefault(src_spk, []).append(src_spk)
        results["ref_emb"].setdefault(src_spk, []).append(embed(wav))
    for (sig_id, src_spk, tgt_spk), conv_file in sorted(convs.items()):
        if (sig_id, src_spk) not in origs:
            continue
        cwav, _ = read_audio(conv_file, sr)
        results["test_emb"].setdefault(src_spk, {}).setdefault(
            tgt_spk, []).append(embed(cwav))

    spks = list(results["ref_emb"].keys())
    mean_emb = {spk: np.mean(results["ref_emb"][spk], axis=0) for spk in spks}
    for src_spk in spks:
        results["emb_dist"].setdefault(src_spk, {})
        results["test_class"].setdefault(src_spk, {})
        for tgt_spk in spks:
            embs = results["test_emb"].get(src_spk, {}).get(tgt_spk, [])
            results["emb_dist"][src_spk][tgt_spk] = [
                cosine(mean_emb[tgt_spk], e) for e in embs
            ]
            # nearest mean embedding, euclidean (reference :175-181)
            means = np.stack([mean_emb[s] for s in spks])
            results["test_class"][src_spk][tgt_spk] = [
                spks[int(np.argmin(np.linalg.norm(means - e, axis=1)))]
                for e in embs
            ]

    if out_filename is not None:
        with open(out_filename, "wb") as f:
            pickle.dump(results, f)
    return results


def evaluate(conv_items, target_items, sr: int = 16000,
             ecapa_checkpoint: str | None = None, device=None) -> dict:
    """In-memory API: conv_items [(wav, tgt_spk)], target_items [(wav, spk)].

    Returns mean cosine similarity vs target-mean embeddings and
    nearest-mean accuracy.
    """
    embed = SpeakerEmbedder(sr, ecapa_checkpoint, device)

    by_spk: dict = {}
    for wav, spk in target_items:
        by_spk.setdefault(spk, []).append(embed(wav))
    means = {spk: np.mean(v, axis=0) for spk, v in by_spk.items()}

    sims, correct = [], 0
    per_item = []
    for wav, tgt in conv_items:
        e = embed(wav)
        sim = cosine(e, means[tgt])
        sims.append(sim)
        pred = max(means, key=lambda s: cosine(e, means[s]))
        correct += int(pred == tgt)
        per_item.append({"target": tgt, "similarity": sim, "predicted": pred})
    return {
        "backend": embed.backend,
        "mean_similarity": float(np.mean(sims)) if sims else float("nan"),
        "accuracy": correct / len(conv_items) if conv_items else float("nan"),
        "items": per_item,
    }
