"""The port's evaluation harness against the JAX package's, on the CPU:
speaker similarity (``eval/speaker_rec.py``), ASR (``eval/asr.py``), the
report (``eval/report.py``), the presets, the ``run_test`` orchestrator and
the ``import_pretrained`` rehearsal, on signals and checkpoints the test
writes from seeds (a tiny Whisper by the recipe of
tests/test_asr_integration.py, a speechbrain-layout ECAPA at the published
width, MOSNet slots, a torchcrepe CREPE-tiny, a Microsoft-layout WavLM).

Tolerances: embeddings, cosine similarities and MOS within 1e-5 (relative
to the largest); nearest-mean classes, transcripts, WER and CER equal; the
MCD pickles within 1e-9 (the same numpy); the report's HTML and JSON
identical from the same results; run_test's HTML identical and its JSON
within 1e-5.
"""

import json
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from td_vc_gan_tpu.cli import import_pretrained as jimport
from td_vc_gan_tpu.cli import run_test as jrun_test
from td_vc_gan_tpu.data.audio_io import write_audio
from td_vc_gan_tpu.eval import asr as jasr
from td_vc_gan_tpu.eval import presets as jpresets
from td_vc_gan_tpu.eval import report as jreport
from td_vc_gan_tpu.eval import speaker_rec as jspk
from td_vc_gan_tpu.models import mosnet as jmosnet
from td_vc_gan_tpu_torch import testing
from td_vc_gan_tpu_torch.cli import gen_boxplots, import_pretrained, run_test
from td_vc_gan_tpu_torch.config import load_config, parse_overrides
from td_vc_gan_tpu_torch.eval import asr, presets, report, speaker_rec
from td_vc_gan_tpu_torch.models import ecapa
from td_vc_gan_tpu_torch.models import wavlm as tw
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.models.layers import init_weights
from td_vc_gan_tpu_torch.training import checkpoint as ckpt
from td_vc_gan_tpu_torch.training import torch_interop as ti

torch.set_num_threads(1)

SR = 16000
RTOL = 1e-5
MCD_RTOL = 1e-9
SPEAKERS = {"sa": 110.0, "sb": 160.0, "sc": 230.0}
# the tiny G of tests/test_torch_port_cli.py
G_OVERRIDES = ["model.generator.decoder_ratios=[10,4,2,2]",
               "model.generator.decoder_channels=[16,16,8,8,4]",
               "model.generator.content_dim=8", "model.generator.conditional_dim=8",
               "model.generator.num_enc_layers=2", "model.generator.mrf_kernel_sizes=[3]",
               "model.generator.mrf_dilations=[1,3]"]


def voiced(f0, seconds, seed, vibrato=0.02):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + vibrato * np.sin(2 * np.pi * 5 * t))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    return (0.2 * x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def same(got, want, rtol):
    """Nested dicts/lists/arrays equal in structure; numbers within
    ``rtol`` of the largest in their leaf; strings equal."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], str):
        assert list(got) == list(want)
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], (dict, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, rtol)
    elif isinstance(want, str) or want is None:
        assert got == want
    else:
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        if fin.any():
            scale = max(np.abs(w[fin]).max(), 1e-30)
            assert np.abs(g[fin] - w[fin]).max() <= rtol * scale


@pytest.fixture(scope="module")
def signals(tmp_path_factory):
    """Two phrases by three speakers and every conversion, 0.8 s each."""
    d = tmp_path_factory.mktemp("signals")
    for p, phrase in enumerate(("001", "002")):
        for s, (src, f0) in enumerate(SPEAKERS.items()):
            write_audio(d / f"{phrase}-{src}-X-orig.wav", voiced(f0, 0.8, 10 * p + s), SR)
            for t, (tgt, f0t) in enumerate(SPEAKERS.items()):
                write_audio(d / f"{phrase}-{src}-{tgt}-conv.wav",
                            voiced(0.5 * (f0 + f0t), 0.8, 100 + 10 * p + 3 * s + t), SR)
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Seeded checkpoints: ECAPA (published width), MOSNet slots, a tiny
    Whisper, CREPE-tiny in torchcrepe's layout, a tiny Microsoft WavLM."""
    d = tmp_path_factory.mktemp("ckpts")
    torch.save({k: torch.from_numpy(v) for k, v in ecapa.init_ecapa_params(2).items()},
               d / "embedding_model.ckpt")
    rng = np.random.default_rng(3)
    slots = jmosnet.init_mosnet_params(1)
    for k in slots:
        if k.endswith(".bias"):
            slots[k] = (0.1 * rng.standard_normal(slots[k].shape)).astype(np.float32)
    np.savez(d / "mosnet.npz", **slots)
    testing.tiny_whisper_checkpoint(d / "whisper")
    torch.save(testing.torchcrepe_state_dict(4), d / "tiny.pth")
    cfg = tw.WavLMConfig(extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=32,
                         encoder_ffn_embed_dim=64, encoder_attention_heads=4,
                         layer_norm_first=True,
                         conv_feature_layers=((16, 10, 5),) + ((16, 3, 2),) * 4
                         + ((16, 2, 2),) * 2, conv_pos=16, conv_pos_groups=4,
                         num_buckets=32, max_distance=80)
    torch.save(testing.microsoft_wavlm_checkpoint(init_weights(tw.WavLM(cfg), 5)),
               d / "wavlm.pt")
    return d


def test_presets_match():
    assert presets.ALL_STAGES == jpresets.ALL_STAGES
    names = ["001-p225-p226-conv.wav", "p225_003_p225-p226_conv.wav", "p225_003_p225-X_orig.wav",
             "arctic_a0001_cmu_us_bdl_arctic-cmu_us_slt_arctic_conv.wav",
             "arctic_a0001_cmu_us_bdl_arctic-X_orig.wav", "1234_5_6_1234-X_orig.wav", "x.wav"]
    for key, preset in jpresets.PRESETS.items():
        assert presets.get(key).stages == preset.stages
        assert [presets.get(key).parse(n) for n in names] == [preset.parse(n) for n in names]
    assert presets.get("plain") is None


def test_mel_stats_and_ecapa_embedders(ckpts):
    wavs = [voiced(f0, 1.1, i) for i, f0 in enumerate(SPEAKERS.values())]
    port, ref = speaker_rec.SpeakerEmbedder(device="cpu"), jspk.SpeakerEmbedder()
    assert port.backend == ref.backend == "mel_stats"
    for w in wavs:
        same(port(w), ref(w), RTOL)
    ck = str(ckpts / "embedding_model.ckpt")
    port = speaker_rec.SpeakerEmbedder(ecapa_checkpoint=ck, device="cpu")
    ref = jspk.SpeakerEmbedder(ecapa_checkpoint=ck)
    assert port.backend == ref.backend == "ecapa"
    for w in wavs:
        same(port(w), ref(w), RTOL)
    conv = [(voiced(150.0, 0.9, 7), "sb"), (voiced(225.0, 0.9, 8), "sc")]
    target = list(zip(wavs, SPEAKERS))
    same(speaker_rec.evaluate(conv, target, device="cpu"), jspk.evaluate(conv, target), RTOL)


@pytest.mark.parametrize("backend", ["mel_stats", "ecapa"])
def test_speaker_rec_protocol(signals, ckpts, tmp_path, backend):
    ck = str(ckpts / "embedding_model.ckpt") if backend == "ecapa" else None
    got = speaker_rec.test_speaker_rec(tmp_path / "port", signals, ecapa_checkpoint=ck,
                                       device="cpu")
    want = jspk.test_speaker_rec(tmp_path / "jax", signals, ecapa_checkpoint=ck)
    assert got["backend"] == backend
    same(got, want, RTOL)
    with open(tmp_path / "port", "rb") as f:
        same(pickle.load(f), want, RTOL)


def test_wer_cer_and_whisper_transcripts(ckpts):
    for ref, hyp in (("the cat sat", "the cat sat"), ("the cat sat", "a cat sat down"),
                     ("", "x"), ("Hello World", "hello  world")):
        assert asr.wer(ref, hyp) == jasr.wer(ref, hyp)
        assert asr.cer(ref, hyp) == jasr.cer(ref, hyp)
    assert not asr.Transcriber(None).available
    with pytest.raises(RuntimeError):
        asr.Transcriber(None)(voiced(150.0, 0.5, 0))
    path = str(ckpts / "whisper")
    port, ref = asr.Transcriber(path, device="cpu"), jasr.Transcriber(path)
    assert port.pipe.device == torch.device("cpu")
    for i in range(3):
        w = voiced(120.0 + 40 * i, 0.8, i)
        assert port(w) == ref(w)
    pairs = [(voiced(150.0, 0.8, 1), "hello world"), (voiced(140.0, 0.8, 2), voiced(140, 0.8, 3))]
    assert asr.evaluate(pairs, path, device="cpu") == jasr.evaluate(pairs, path)
    assert asr.evaluate(pairs, None) == jasr.evaluate(pairs, None)


@pytest.fixture(scope="module")
def results_dir(signals, ckpts, tmp_path_factory):
    """The JAX package's result pickles for ``signals`` (MCD, speaker rec,
    MOS) plus an ASR result, beside a copy of the signals."""
    from td_vc_gan_tpu.eval import mcd as jmcd
    from td_vc_gan_tpu.eval import mosnet as jeval_mosnet
    from td_vc_gan_tpu.eval.mcd import parse_fn

    d = tmp_path_factory.mktemp("results")
    shutil.copytree(signals, d / "signals")
    jmcd.test_mcd(d / "mcd_results", d / "signals")
    jspk.test_speaker_rec(d / "spkrec_results", d / "signals")
    raw = jeval_mosnet.predict_mos_native(d / "signals", str(ckpts / "mosnet.npz"))
    with open(d / "mosnet_results", "wb") as f:
        pickle.dump(jeval_mosnet.to_matrices(raw["scores"], parse_fn), f)
    wers = {"sa": {"sb": [0.5, 0.25]}, "sb": {"sa": [1.0, float("nan")]}}
    with open(d / "asr_results", "wb") as f:
        pickle.dump({"asr_results_wer": 0.5833, "asr_results_cer": 0.31,
                     "asr_results_wer_pair": jreport.dict_stats_per_pair(wers),
                     "asr_results_cer_pair": jreport.dict_stats_per_pair(wers)}, f)
    return d


@pytest.mark.parametrize("layout", ["parallel", "nonparallel"])
def test_report_identical(results_dir, tmp_path, layout):
    out = {}
    for tag, mod in (("port", report), ("jax", jreport)):
        shutil.copytree(results_dir, tmp_path / tag)
        build = getattr(mod, f"build_html_{layout}")
        out[tag] = build(tmp_path / tag / "index.html", tmp_path / tag)
    assert out["port"].read_text() == out["jax"].read_text()
    assert out["port"].with_suffix(".json").read_text() == \
        out["jax"].with_suffix(".json").read_text()
    merged = report.load_dicts(results_dir)
    assert {"mcd_result_conv", "emb_dist", "mos_result_conv", "asr_results_wer"} <= set(merged)
    assert report.dict_stats(merged["mcd_result_conv"]) == \
        jreport.dict_stats(merged["mcd_result_conv"])
    assert report.dict_correct_rate(merged["test_class"]) == \
        jreport.dict_correct_rate(merged["test_class"])


def test_run_test_skip_generate(signals, ckpts, tmp_path, capsys):
    """Both orchestrators on one signals directory, every stage the vctk
    preset runs but ASR (speaker similarity with mel_stats, MOS from the
    .npz, info of an empty run directory)."""
    (tmp_path / "run").mkdir()
    for tag in ("port", "jax"):
        shutil.copytree(signals, tmp_path / tag / "signals")
    args = ["--load_path", str(tmp_path / "run"), "--data_path", str(tmp_path),
            "--skip_generate", "--mosnet_ckpt", str(ckpts / "mosnet.npz")]
    run_test.main(args + ["--save_path", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    jrun_test.main(args + ["--save_path", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    assert port_out.splitlines()[-1] == jax_out.splitlines()[-1]  # the MCD summary
    for name, rtol in (("mcd_results", MCD_RTOL), ("spkrec_results", RTOL),
                       ("mosnet_results", RTOL), ("info", 0)):
        with open(tmp_path / "port" / name, "rb") as f, open(tmp_path / "jax" / name, "rb") as g:
            same(pickle.load(f), pickle.load(g), rtol)
    assert (tmp_path / "port" / "index.html").read_text() == \
        (tmp_path / "jax" / "index.html").read_text()
    same(json.loads((tmp_path / "port" / "index.json").read_text()),
         json.loads((tmp_path / "jax" / "index.json").read_text()), RTOL)
    assert not (tmp_path / "port" / "asr_results").exists()


def test_run_test_parse_regex():
    parse = run_test.make_parse_fn(r"(\w+)_(\w+)_(\w+)_(src|gen)\.wav", "src=orig,gen=conv")
    want = jrun_test.make_parse_fn(r"(\w+)_(\w+)_(\w+)_(src|gen)\.wav", "src=orig,gen=conv")
    for name in ("a_b_c_src.wav", "a_b_c_gen.wav", "a_b_c_ref.wav"):
        assert parse(name) == want(name)
    with pytest.raises(ValueError):
        run_test.make_parse_fn(r"(\w+)_(\w+)\.wav")
    with pytest.raises(SystemExit):
        run_test.main(["--save_path", "x", "--load_path", "x", "--data_path", "x",
                       "--stages", "mcd,nope", "--device", "cpu"])


def test_run_test_with_generation(tmp_path, ckpts):
    """The port's run_test end to end on the CPU: a tiny G's run directory
    and a test manifest of one utterance by each of 3 speakers (one
    phrase), conversion through ``generate_signals``, then MCD, ECAPA
    speaker similarity, MOS, ASR, info and the report."""
    data = tmp_path / "data"
    data.mkdir()
    lines = []
    for s, (spk, f0) in enumerate(SPEAKERS.items()):
        write_audio(data / f"{spk}_001.wav", voiced(f0, 0.6, s), SR)
        lines.append(f"{data / f'{spk}_001.wav'}|{spk}")
    (data / "test_files").write_text("\n".join(lines) + "\n")
    with open(data / "speakers", "wb") as f:
        pickle.dump({spk: i for i, spk in enumerate(SPEAKERS)}, f)
    run = tmp_path / "run"
    run.mkdir()
    cfg = load_config(None, parse_overrides(G_OVERRIDES))
    cfg.save(run / "config.yaml")
    G = generator_from_config(cfg.model.generator, len(SPEAKERS), "cpu", seed=3)
    ti.save_torch_file(ti.port_to_torch(G.state_dict(), ckpt.generator_entries(cfg)),
                       run / "latest-G.pt")
    out = tmp_path / "out"
    run_test.main(["--save_path", str(out), "--load_path", str(run), "--data_path", str(data),
                   "--ecapa_checkpoint", str(ckpts / "embedding_model.ckpt"),
                   "--mosnet_ckpt", str(ckpts / "mosnet.npz"), "--asr_model",
                   str(ckpts / "whisper"), "--crepe_weights", str(ckpts / "tiny.pth"),
                   "--device", "cpu"])
    assert len(list((out / "signals").glob("*-conv.wav"))) == 9
    assert len(list((out / "signals").glob("*-X-orig.wav"))) == 3
    for name in ("mcd_results", "spkrec_results", "mosnet_results", "asr_results", "info",
                 "index.html", "index.json"):
        assert (out / name).exists(), name
    with open(out / "mcd_results", "rb") as f:
        mcds = pickle.load(f)
    base = [v for s, row in mcds["mcd_result_orig"].items() for t, vs in row.items() if s != t
            for v in vs]
    assert len(base) == 6 and np.isfinite(base).all()
    with open(out / "spkrec_results", "rb") as f:
        spk = pickle.load(f)
    assert spk["backend"] == "ecapa" and len(spk["test_emb"]["sa"]["sb"]) == 1
    with open(out / "asr_results", "rb") as f:
        assert np.isfinite(pickle.load(f)["asr_results_cer"])
    summary = json.loads((out / "index.json").read_text())
    assert summary["speakers"] == sorted(SPEAKERS) and summary["spk_backend"] == "ecapa"
    pytest.importorskip("matplotlib")
    gen_boxplots.main([f"ours={out / 'index.json'}", "--out", str(tmp_path / "box.png")])


def test_import_pretrained_rehearsal(ckpts, tmp_path):
    """Every importer with --no_gates on the port and on the JAX package: the
    same summary (import, sanity and gate of each, its detail's numbers
    within 1e-3 of each other)."""
    args = ["--crepe", str(ckpts / "tiny.pth"), "--wavlm", str(ckpts / "wavlm.pt"),
            "--mosnet", str(ckpts / "mosnet.npz"), "--ecapa",
            str(ckpts / "embedding_model.ckpt"), "--whisper", str(ckpts / "whisper"),
            "--no_gates"]
    assert import_pretrained.main(args + ["--json_out", str(tmp_path / "port.json"),
                                          "--device", "cpu"]) == 0
    assert jimport.main(args + ["--json_out", str(tmp_path / "jax.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert list(got) == list(want) == ["crepe", "wavlm", "mosnet", "ecapa", "whisper"]
    num = r"-?\d+\.\d+"
    for name in want:
        for key in ("import", "sanity", "gate"):
            assert got[name][key] == want[name][key], (name, key)
        assert re.sub(num, "#", got[name]["detail"]) == re.sub(num, "#", want[name]["detail"])
        np.testing.assert_allclose([float(x) for x in re.findall(num, got[name]["detail"])],
                                   [float(x) for x in re.findall(num, want[name]["detail"])],
                                   rtol=1e-3, atol=1e-3)
        assert got[name]["import"] and got[name]["sanity"], name
    assert import_pretrained.main([]) == 2
