"""Pretrained-weight rehearsal: import every third-party checkpoint the
reference depends on, probe each import, and print one summary.

Counterpart of ``td_vc_gan_tpu/cli/import_pretrained.py`` on the port's
loaders and models, with the same checks, summary and exit code, plus
``--device`` (the probes run on the CUDA card unless ``--device cpu``).

The reference silently assumes these files exist and work
(WavLM-Large.pt: model/ssl_encoder.py:127-133; torchcrepe tiny.pth:
util/crepe.py:12,53; Whisper: test_scripts/common/test_asr.py:34-43;
speechbrain ECAPA: test_scripts/vctk/test_speaker_rec.py:17-56; MOSNet h5:
test_scripts/vctk/run_test.sh:26-30). The repository ships none of them, so
the importers have only ever seen fabricated checkpoints — this CLI scripts the
first contact with the real files as import -> sanity -> fidelity gate, one
command, instead of improvising it in the field.

Per checkpoint:
- import: the converter must accept the file;
- sanity: a forward runs, shapes/finiteness hold (always enforced);
- gate: an accuracy probe that only trained weights pass (CREPE decodes a
  220 Hz tone to ~220 Hz; MOSNet rates a tone above white noise; ECAPA
  separates same-speaker from cross-speaker pairs; WavLM features are
  perturbation-stable; Whisper transcribes without crashing). Gates report
  PASS/FAIL but only fail the command without ``--no_gates`` — fabricated
  rehearsal checkpoints exercise every code path with ``--no_gates``.

Usage:
    python -m td_vc_gan_tpu_torch.cli.import_pretrained \
        --wavlm WavLM-Large.pt --crepe tiny.pth --mosnet mosnet.h5 \
        --ecapa embedding_model.ckpt [--ecapa_classifier classifier.ckpt] \
        --whisper ./whisper-medium [--no_gates] [--json_out summary.json] \
        [--device cpu]

Exit code 0 iff every requested import + sanity (and, without --no_gates,
every gate) passed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from td_vc_gan_tpu_torch import resolve_device


def _tone(freq: float, seconds: float = 0.5, sr: int = 16000,
          noise: float = 0.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.2 * np.sin(2 * np.pi * freq * t)
    if noise:
        sig = sig + noise * rng.standard_normal(len(t))
    return sig.astype(np.float32)


def _voice(f0: float, seconds: float = 1.0, sr: int = 16000,
           seed: int = 0) -> np.ndarray:
    """Harmonic stack with a formant-ish envelope — enough structure for
    speaker-embedding and MOS probes."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = sum(
        (0.2 + np.exp(-0.5 * ((h * f0 - 700) / 400) ** 2))
        * np.sin(2 * np.pi * h * f0 * t)
        for h in range(1, 8)
    )
    return (0.1 * sig + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


def check_crepe(path: str, device) -> dict:
    from td_vc_gan_tpu_torch.models import crepe as crepe_mod
    from td_vc_gan_tpu_torch.training.torch_import import load_torchcrepe

    net = load_torchcrepe(path).to(device).eval()
    sig = _tone(220.0, noise=0.001)[None]
    with torch.no_grad():
        pitch, act = crepe_mod.filtered_pitch(net, torch.from_numpy(sig).to(device))
    pitch, act = pitch.cpu().numpy(), act.cpu().numpy()
    sane = bool(
        act.shape == (1, sig.shape[1] // crepe_mod.HOP + 1, crepe_mod.PITCH_BINS)
        and np.isfinite(act).all()
        and (act >= 0).all() and (act <= 1).all()
    )
    voiced = pitch[pitch > 0]
    med = float(np.median(voiced)) if voiced.size else 0.0
    # 20-cent bins + decoder slack: a trained CREPE lands within 3% of 220 Hz
    gate = bool(voiced.size > 0 and abs(med - 220.0) / 220.0 < 0.03)
    return {"sanity": sane, "gate": gate,
            "detail": f"median pitch on 220 Hz tone: {med:.1f} Hz"}


def check_wavlm(path: str, device) -> dict:
    from td_vc_gan_tpu_torch.models.wavlm import WavLM, load_wavlm_checkpoint

    cfg, state = load_wavlm_checkpoint(path)
    model = WavLM(cfg)
    model.load_state_dict(state)
    model = model.to(device).eval()
    sig = _voice(140.0, seconds=0.5)
    stride = 1
    for _, _, s in cfg.conv_feature_layers:
        stride *= s
    sig2 = sig + 1e-3 * np.random.default_rng(1).standard_normal(len(sig)).astype(np.float32)
    with torch.no_grad():
        feats, feats2 = (model(torch.from_numpy(x)[None].to(device)).cpu().numpy()
                         for x in (sig, sig2))
    sane = bool(
        feats.shape[0] == 1 and feats.shape[-1] == cfg.encoder_embed_dim
        and abs(feats.shape[1] - len(sig) // stride) <= 2
        and np.isfinite(feats).all()
    )
    # trained representations are locally smooth: tiny input noise must not
    # move the features much (cosine per frame)
    num = (feats * feats2).sum(-1)
    den = np.linalg.norm(feats, axis=-1) * np.linalg.norm(feats2, axis=-1) + 1e-9
    cos = float((num / den).mean())
    return {"sanity": sane, "gate": bool(cos > 0.98),
            "detail": f"{cfg.encoder_layers} layers, d={cfg.encoder_embed_dim}, "
                      f"perturbation cosine {cos:.4f}"}


def check_mosnet(path: str, device) -> dict:
    from td_vc_gan_tpu_torch.models.mosnet import MOSPredictor, load_mosnet

    pred = MOSPredictor(load_mosnet(path), device)
    mos_voice = pred.score(_voice(130.0, seconds=1.0))
    noise = 0.1 * np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    mos_noise = pred.score(noise)
    sane = bool(np.isfinite(mos_voice) and np.isfinite(mos_noise))
    return {"sanity": sane, "gate": bool(mos_voice > mos_noise),
            "detail": f"MOS(voice)={mos_voice:.2f} vs MOS(noise)={mos_noise:.2f}"}


def check_ecapa(path: str, classifier: str | None, device) -> dict:
    from td_vc_gan_tpu_torch.models.ecapa import EcapaEmbedder

    emb = EcapaEmbedder.from_speechbrain(path, classifier, device=device)
    a1 = emb.embed(_voice(120.0, seed=0))
    a2 = emb.embed(_voice(120.0, seed=1))
    b1 = emb.embed(_voice(260.0, seed=2))

    def cos(u, v):
        return float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-9))

    same, cross = cos(a1, a2), cos(a1, b1)
    sane = bool(np.isfinite(a1).all() and a1.ndim == 1)
    return {"sanity": sane, "gate": bool(same > cross),
            "detail": f"dim={a1.shape[0]}, same-voice cos {same:.3f} "
                      f"vs cross-voice {cross:.3f}"}


def check_whisper(path: str, device) -> dict:
    from td_vc_gan_tpu_torch.eval.asr import Transcriber

    t = Transcriber(path, device=device)
    text = t(_voice(130.0, seconds=1.0))
    sane = bool(t.available and isinstance(text, str))
    # any non-crashing decode exercises the full transformers pipeline; a
    # trained model yields *some* token stream
    return {"sanity": sane, "gate": sane,
            "detail": f"transcribed 1 s probe -> {text[:40]!r}"}


CHECKS = {
    "crepe": lambda a, dev: check_crepe(a.crepe, dev),
    "wavlm": lambda a, dev: check_wavlm(a.wavlm, dev),
    "mosnet": lambda a, dev: check_mosnet(a.mosnet, dev),
    "ecapa": lambda a, dev: check_ecapa(a.ecapa, a.ecapa_classifier, dev),
    "whisper": lambda a, dev: check_whisper(a.whisper, dev),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--crepe", help="torchcrepe tiny.pth / full.pth")
    p.add_argument("--wavlm", help="Microsoft WavLM-Large.pt (or any WavLM .pt)")
    p.add_argument("--mosnet", help="MOSNet Keras .h5 or .npz")
    p.add_argument("--ecapa", help="speechbrain ECAPA embedding_model.ckpt")
    p.add_argument("--ecapa_classifier", help="optional classifier.ckpt")
    p.add_argument("--whisper", help="local whisper checkpoint dir")
    p.add_argument("--no_gates", action="store_true",
                   help="only require import+sanity (fabricated-ckpt rehearsal)")
    p.add_argument("--json_out", help="write the summary as JSON here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    requested = [(n, fn) for n, fn in CHECKS.items() if getattr(a, n)]
    if not requested:
        print("nothing to do: pass at least one of "
              + ", ".join(f"--{n}" for n in CHECKS))
        return 2

    dev = resolve_device(a.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    summary: dict = {}
    ok = True
    for name, fn in requested:
        try:
            r = fn(a, dev)
            r["import"] = True
        except Exception as e:  # noqa: BLE001 — report, don't crash the rest
            r = {"import": False, "sanity": False, "gate": False,
                 "detail": f"{type(e).__name__}: {e}"}
        summary[name] = r
        gate_txt = ("PASS" if r["gate"] else
                    ("skip" if a.no_gates else "FAIL"))
        print(f"{name:8s} import={'ok' if r['import'] else 'FAIL'} "
              f"sanity={'ok' if r['sanity'] else 'FAIL'} gate={gate_txt}  "
              f"{r['detail']}")
        ok = ok and r["import"] and r["sanity"] and (r["gate"] or a.no_gates)

    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    print("ALL OK" if ok else "FAILURES above")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
