"""The slice as a whole on the CPU: the port's train CLI for one epoch and a
resume, then its conversion CLI, on a corpus the test writes, with the tiny
overrides of the JAX package's end-to-end test (tests/test_train_e2e.py) and
a batch for one process. What the JAX package reads back of the run (its
config loader, its reference-format importer) is held against the port.

Tolerances: generator outputs within 1e-5 of max|ref| (f32 on both sides);
converted audio within 1e-4 plus one 16-bit step of the WAV files.
"""

import contextlib
import io
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.cli import generate_with_target as jgen_cli
from td_vc_gan_tpu.models.generator import generator_from_config as jax_generator
from td_vc_gan_tpu.training import checkpoint as jckpt
from td_vc_gan_tpu_torch import testing
from td_vc_gan_tpu_torch.cli import generate_with_target as gen_cli
from td_vc_gan_tpu_torch.cli import train as train_cli
from td_vc_gan_tpu_torch.config import load_config
from td_vc_gan_tpu_torch.data.audio_io import read_audio, write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

SR = 16000
G_RTOL = 1e-5
# converted audio, port against JAX: 1e-4 (as tests/test_torch_port_convert.py)
# plus one step of the 16-bit WAV both CLIs write
AUDIO_ATOL = 1e-4 + 1 / 32767

OVERRIDES = [
    "model.generator.decoder_ratios=[10,4,2,2]",
    "model.generator.decoder_channels=[16,16,8,8,4]",
    "model.generator.content_dim=8",
    "model.generator.conditional_dim=8",
    "model.generator.num_enc_layers=2",
    "model.generator.mrf_kernel_sizes=[3]",
    "model.generator.mrf_dilations=[1,3]",
    "model.discriminator.num_channels_base=4",
    "train.batch_size=4",  # one process: 8 files, 2 steps per epoch
    "train.num_epoch=1",
    "train.max_segment=5120",
    "train.mel_fft_sizes=[512]",
    "train.num_workers=2",
    "test.max_segment=5120",
    "test.num_tests=1",
    "log.save_interval=1",
    "log.gen_interval=1",
    "log.val_interval=1",
    "log.log_interval=1",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 speakers x 4 utterances of 0.4 s (VCTK-style names); the test
    manifest holds one utterance of each speaker."""
    root = tmp_path_factory.mktemp("port_cli")
    rng = np.random.default_rng(0)
    entries = []
    for spk in range(2):
        for j in range(4):
            t = np.arange(6400) / SR
            sig = 0.25 * np.sin(2 * np.pi * (120 + 60 * spk + 15 * j) * t) * (
                1 + 0.05 * rng.standard_normal(t.size))
            path = root / f"p{spk}_{j:03d}.wav"
            write_audio(path, sig, SR)
            entries.append(f"{path}|p{spk}")
    (root / "train_files").write_text("\n".join(entries) + "\n")
    (root / "test_files").write_text(f"{entries[1]}\n{entries[6]}\n")
    with open(root / "speakers", "wb") as f:
        pickle.dump([("p0", 0), ("p1", 1)], f)
    return root


@pytest.fixture(scope="module")
def run(corpus, tmp_path_factory):
    """One epoch (epochs 0 and 1), then a resume to epoch 2; their logs."""
    path = tmp_path_factory.mktemp("run") / "run"
    argv = ["--save_path", str(path), "--data_path", str(corpus), "--device", "cpu"]
    for o in OVERRIDES:
        argv += ["--override", o]

    def main(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv + extra)
        return out.getvalue().splitlines()

    first = main([])
    second = main(["--load_path", str(path), "--override", "train.num_epoch=2"])
    return path, first, second


def test_train_one_epoch_then_resume(run, corpus):
    path, first, second = run
    steps = [ln for ln in first if ln.startswith("Epoch ")]
    assert [re.search(r"Itt (\d+)", s).group(1) for s in steps] == ["0", "1", "2", "3"]
    for s in steps:
        for key, v in re.findall(r"(\w+): (-?[\d.]+|nan|inf)", s):
            assert np.isfinite(float(v)), (key, s)
    assert sum(ln.startswith("Val Epoch") for ln in first) == 2
    # the files the JAX loop writes, under the same names (orbax/ is the
    # port's torch_state/)
    for name in ("config.yaml", "argv", "latest_epoch", "generated", "torch_state",
                 "step0-G.pt", "step0-D.pt", "step1-G.pt", "step1-D.pt",
                 "latest-G.pt", "latest-D.pt"):
        assert (path / name).exists(), name
    assert not (path / "step0-C.pt").exists()  # no latent classifier in this config
    test_ds = WaveDataset(corpus / "test_files", corpus / "speakers")
    want = set()
    for ep in (0, 1, 2):
        ratios = np.random.default_rng(ep).uniform(0.5, 2.0, size=2)
        ratios[0] = 1.0
        for i in range(2):
            src = int(test_ds[i]["label"])
            tgt = src if i == 0 else int(np.random.default_rng(ep * 100 + i).integers(2))
            base = f"epoch{ep:03d}_sig{i:02d}_{src:1d}-{tgt:1d}"
            want |= {f"{base}_conv_r={ratios[i]:.2f}.wav", f"{base}_orig.wav",
                     f"{base}_rec.wav"}
    assert {p.name for p in (path / "generated").iterdir()} == want
    # the resume takes the full state of epoch 1 and goes on at step 4
    assert any(ln.startswith("Resumed train state epoch 1 (step 4") for ln in second)
    steps = [ln for ln in second if ln.startswith("Epoch ")]
    assert [re.search(r"Itt (\d+)", s).group(1) for s in steps] == ["4", "5"]
    assert (path / "latest_epoch").read_text() == "2" and ckpt.latest_epoch(path) == 2
    digests = [re.search(r"digest (\w+)", ln).group(1) for ln in first + second
               if "digest" in ln]
    assert digests[1] == digests[2]  # saved at epoch 1 == restored


def test_jax_reads_the_run(run):
    """The JAX package loads the port's config.yaml to the same architecture,
    and its reference-format importer reads step1-G.pt to a G whose output is
    within G_RTOL of the port's G."""
    path, _, _ = run
    pc, jc = load_config(path / "config.yaml"), jcfg.load_config(path / "config.yaml")
    for sec in ("generator", "discriminator"):
        a, b = getattr(pc.model, sec), getattr(jc.model, sec)
        for f in a.__dataclass_fields__:
            va, vb = getattr(a, f), getattr(b, f)
            assert (va.__dict__ if hasattr(va, "__dict__") else va) == (
                vb.__dict__ if hasattr(vb, "__dict__") else vb), (sec, f)
    for f in ("max_segment", "batch_size", "num_epoch", "mel_fft_sizes", "lambda_rec", "seed"):
        assert getattr(pc.train, f) == getattr(jc.train, f), f

    blob = torch.load(path / "torch_state" / "epoch_1.pt", weights_only=False)
    G = generator_from_config(pc.model.generator, 2, device="cpu", seed=5)
    G.load_state_dict(blob["G"])
    params, _ = jckpt.import_torch_generator(jc, path / "step1-G.pt")
    jg = jax_generator(jc.model.generator, 2)
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    onehot = np.eye(2, dtype=np.float32)[[1, 0]]
    exc = (0.1 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    want = np.asarray(jax.jit(jg.apply)(params, x, onehot, None, exc)[0])
    with torch.no_grad():
        got = G(torch.from_numpy(x), torch.from_numpy(onehot), torch.from_numpy(exc))[0].numpy()
    assert np.abs(got - want).max() <= G_RTOL * np.abs(want).max()


def jax_draws(seed: int, shape):
    """The start phase and noise the JAX Converter draws for ``seed``."""
    k_phase, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    start = float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi)
    return start, np.array(jax.random.normal(k_noise, shape))


def test_generate_with_target(run, corpus, tmp_path, monkeypatch):
    """Every test utterance to every speaker of the manifest, by the port's
    CLI and by the JAX package's ``generate_signals`` on the same run dir,
    corpus and CREPE weights: the same files, the same conv_log.txt, and
    every WAV within AUDIO_ATOL of the JAX one. The excitation's draws are
    the JAX PRNG's for each call's seed, injected into the port's
    convert_batch."""
    path, _, _ = run
    torch.save(testing.torchcrepe_state_dict(4), tmp_path / "tiny.pth")
    crepe = str(tmp_path / "tiny.pth")
    kernel_call = Converter.convert_batch

    def with_jax_draws(self, signals, labels, f0, mu, mu_tgt, seed=0, start_phase=None,
                       noise=None):
        start_phase, noise = jax_draws(seed, signals.shape)
        return kernel_call(self, signals, labels, f0, mu, mu_tgt, seed, start_phase, noise)

    monkeypatch.setattr(Converter, "convert_batch", with_jax_draws)
    out, ref = tmp_path / "gen", tmp_path / "jax_gen"
    gen_cli.main(["--save_path", str(out), "--load_path", str(path), "--data_path",
                  str(corpus), "--crepe_weights", crepe, "--device", "cpu"])
    jgen_cli.generate_signals(ref, corpus, path, crepe_weights=crepe)
    files = {p.name for p in ref.iterdir()}
    assert {p.name for p in out.iterdir()} == files
    assert len([f for f in files if f.endswith("-conv.wav")]) == 4  # 2 utterances x 2
    assert (out / "conv_log.txt").read_text() == (ref / "conv_log.txt").read_text()
    for name in sorted(files - {"conv_log.txt"}):
        (y, sr), (want, _) = read_audio(out / name), read_audio(ref / name)
        assert sr == SR and y.shape == want.shape == (6400,), name
        assert np.abs(y - want).max() <= AUDIO_ATOL, name


def test_clis_need_a_card_unless_asked_for_the_cpu(monkeypatch, corpus, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--save_path", str(tmp_path / "r"), "--data_path", str(corpus)])
    assert not (tmp_path / "r").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_cli.main(["--save_path", str(tmp_path / "g"), "--load_path", str(tmp_path),
                      "--data_path", str(corpus)])
    for bad in (["--num_processes", "2"], ["--wavlm_checkpoint", "w.pt"]):
        with pytest.raises(SystemExit):
            train_cli.parse_args(["--save_path", "s", "--data_path", "d", *bad])
