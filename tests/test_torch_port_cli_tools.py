"""The port's dataset, conversion and inspection CLIs against the JAX
package's, on inputs the test writes: a tree of speaker folders (3 speakers
x 6 utterances of 0.4 s, 16-bit WAV), a run directory with a tiny G (the
overrides of tests/test_torch_port_cli.py) and a tiny torchcrepe checkpoint.

Tolerances: manifests, speaker pickles, the precorrupt index (its folder
apart) and get_model_info's dict equal; WAVs that both packages compute in
numpy (preprocess, precorrupt) within one 16-bit step; f0_ratios.json within
1e-4 (relative); converted audio within AUDIO_ATOL of
tests/test_torch_port_cli.py (1e-4 plus one 16-bit step). The conversion
CLIs' excitation draws are the JAX PRNG's for each call's seed, injected
into the port's ``Converter.convert``. No JAX train step is compiled here;
the JAX CLIs' ``load_generator`` runs with its ``G.init`` jitted (eager, it
compiles some 400 small programs, ~55 s), which changes nothing it returns:
every tensor of its G comes from ``step0-G.pt``.
"""

import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_cli import AUDIO_ATOL, OVERRIDES, jax_draws

from td_vc_gan_tpu.cli import generate_from_dataset as jfrom_dataset
from td_vc_gan_tpu.cli import generate_with_target as jgen_cli
from td_vc_gan_tpu.cli import generate_from_list as jfrom_list
from td_vc_gan_tpu.cli import get_model_info as jinfo
from td_vc_gan_tpu.cli import merge_datasets as jmerge
from td_vc_gan_tpu.cli import precorrupt_dataset as jprecorrupt
from td_vc_gan_tpu.cli import prepare_dataset as jprepare
from td_vc_gan_tpu.cli import preprocess_dataset as jpreprocess
from td_vc_gan_tpu.cli import sample_f0 as jsample_f0
from td_vc_gan_tpu.cli import subset_dataset as jsubset
from td_vc_gan_tpu.data.dataset import WaveDataset as JaxWaveDataset
from td_vc_gan_tpu.models.generator import generator_from_config as jax_generator
from td_vc_gan_tpu.training import checkpoint as jckpt
from td_vc_gan_tpu_torch import testing
from td_vc_gan_tpu_torch.cli import generate_from_dataset, generate_from_list, get_model_info, \
    merge_datasets, precorrupt_dataset, prepare_dataset, preprocess_dataset, sample_f0, \
    subset_dataset
from td_vc_gan_tpu_torch.config import load_config, parse_overrides
from td_vc_gan_tpu_torch.data.audio_io import read_audio, write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.training import checkpoint as ckpt
from td_vc_gan_tpu_torch.training import torch_interop as ti

torch.set_num_threads(1)

SR = 16000
STEP = 1 / 32767 + 1e-7  # one step of the 16-bit WAVs both packages write
SPEAKERS = ("p225", "p226", "p227")
F0_RTOL = 1e-4


def read(path):
    return read_audio(path)[0]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Speaker folders of VCTK-style WAVs, at two levels of loudness."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    t = np.arange(6400) / SR
    for s, spk in enumerate(SPEAKERS):
        (root / spk).mkdir()
        for j in range(6):
            f0 = 110 + 50 * s + 12 * j
            sig = (0.05 + 0.2 * (j % 2)) * np.sin(2 * np.pi * f0 * t) * (
                1 + 0.05 * rng.standard_normal(t.size))
            write_audio(root / spk / f"{spk}_{j:03d}.wav", sig, SR)
    return root


def same_tree(a, b, files):
    for name in files:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def prepared(raw, tmp_path_factory):
    """prepare_dataset by each package, Python's random seeded alike."""
    out = {}
    for tag, mod in (("port", prepare_dataset), ("jax", jprepare)):
        out[tag] = tmp_path_factory.mktemp(f"prepared_{tag}")
        random.seed(7)
        mod.main([str(raw), "--save_folder", str(out[tag]), "--ext", ".wav",
                  "--test_size", "1", "--out_of_sample_speakers", "1", "--test_random"])
    return out


def test_prepare_dataset(prepared):
    port, ref = prepared["port"], prepared["jax"]
    same_tree(port, ref, ("train_files", "test_files", "speakers", "test_oos_files",
                          "speakers_oos"))
    train = (port / "train_files").read_text().splitlines()
    test = (port / "test_files").read_text().splitlines()
    with open(port / "speakers", "rb") as f:
        speakers = pickle.load(f)
    # 2 in-sample speakers, 6 > 5 * 1 utterances each: 1 test, 5 train
    assert len(speakers) == 2 and len(train) == 10 and len(test) == 2
    assert {ln.split("|")[1] for ln in test} == set(speakers)


def test_preprocess_dataset(raw, tmp_path):
    jpreprocess.main([str(raw), "--save_folder", str(tmp_path / "jax"),
                      "--normalization_db", "-30"])
    preprocess_dataset.main([str(raw), "--save_folder", str(tmp_path / "port"),
                             "--normalization_db", "-30"])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.wav"))
    assert len(files) == 18
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.wav"))
    for rel in files:
        y, want = read(tmp_path / "port" / rel), read(tmp_path / "jax" / rel)
        assert y.shape == want.shape and np.abs(y - want).max() <= STEP, rel
        rms_db = 20 * np.log10(np.sqrt(np.mean(y.astype(np.float64) ** 2)))
        assert abs(rms_db + 30) < 0.01, rel


def test_merge_and_subset(prepared, tmp_path):
    """merge_datasets of the prepared dataset and a copy with its speakers
    renamed, then subset_dataset of the merge (2 speakers x 2 utterances of
    train_files, seed 3)."""
    root = tmp_path
    a, b = "a", "b"
    for name, rename in ((a, ""), (b, "x")):
        (root / name).mkdir()
        for fn in ("train_files", "test_files"):
            text = (prepared["port"] / fn).read_text()
            (root / name / fn).write_text(text.replace("|", f"|{rename}"))
        with open(prepared["port"] / "speakers", "rb") as f:
            spk = {rename + k: v for k, v in pickle.load(f).items()}
        with open(root / name / "speakers", "wb") as f:
            pickle.dump(spk, f)
    for tag, merge, subset in (("port", merge_datasets, subset_dataset),
                               ("jax", jmerge, jsubset)):
        merge.main([a, b, f"merged_{tag}", "--root_folder", str(root)])
        subset.main([str(root / f"merged_{tag}"), str(tmp_path / f"sub_{tag}"),
                     "--num_speakers", "2", "--utts_per_speaker", "2",
                     "--manifest", "train_files", "--seed", "3"])
    same_tree(root / "merged_port", root / "merged_jax",
              ("train_files", "test_files", "speakers"))
    same_tree(tmp_path / "sub_port", tmp_path / "sub_jax", ("train_files", "speakers"))
    with open(root / "merged_port" / "speakers", "rb") as f:
        assert sorted(pickle.load(f).values()) == [0, 1, 2, 3]
    assert len((tmp_path / "sub_port" / "train_files").read_text().split()) == 4


def test_precorrupt_dataset(prepared, tmp_path):
    """Two variants of each of 4 utterances by each package: the same index
    (its folder apart) and every variant within one 16-bit step; the port's
    WaveDataset replays its index as the JAX package's replays its own."""
    manifest = tmp_path / "manifest"
    lines = (prepared["port"] / "train_files").read_text().splitlines()
    manifest.write_text("\n".join(lines[::3]) + "\n")
    args = [str(manifest), "--variants", "2", "--normalization_db", "-30", "--seed", "5"]
    jprecorrupt.main(args + ["--save_folder", str(tmp_path / "jax"), "--workers", "2"])
    precorrupt_dataset.main(args + ["--save_folder", str(tmp_path / "port"), "--workers", "1"])
    indexes = {}
    for tag in ("jax", "port"):
        with open(tmp_path / tag / "precorrupt_index.pkl", "rb") as f:
            indexes[tag] = pickle.load(f)
    assert len(indexes["port"]) == 4
    assert indexes["port"] == {k: [v.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                                   for v in vs] for k, vs in indexes["jax"].items()}
    for variants in indexes["port"].values():
        assert len(variants) == 2
        for v in variants:
            y, want = read(v), read(v.replace(str(tmp_path / "port"), str(tmp_path / "jax")))
            assert y.shape == want.shape and np.abs(y - want).max() <= STEP, v
    kw = dict(max_segment_size=5120, normalization_db=-30, data_augment=True, corrupt=True,
              pad_to_max=True, seed=9)
    port = WaveDataset(manifest, prepared["port"] / "speakers",
                       precorrupted_index=tmp_path / "port" / "precorrupt_index.pkl", **kw)
    ref = JaxWaveDataset(manifest, prepared["port"] / "speakers",
                         precorrupted_index=tmp_path / "jax" / "precorrupt_index.pkl", **kw)
    for i in range(len(port)):
        for epoch in (0, 1):
            got, want = port.__getitem__(i, epoch), ref.__getitem__(i, epoch)
            np.testing.assert_array_equal(got["signal"], want["signal"])
            assert np.abs(got["corrupted"] - want["corrupted"]).max() <= STEP
            assert np.abs(got["corrupted"]).max() > 0


@pytest.fixture(scope="module")
def run(prepared, tmp_path_factory):
    """A run directory with the tiny G's step0-G.pt and its config, a
    torchcrepe checkpoint, and a pairs file beside the prepared manifests."""
    root = tmp_path_factory.mktemp("gen_run")
    cfg = load_config(None, parse_overrides(OVERRIDES))
    cfg.save(root / "config.yaml")
    data = prepared["port"]
    with open(data / "speakers", "rb") as f:
        num_spk = len(pickle.load(f))
    G = generator_from_config(cfg.model.generator, num_spk, "cpu", seed=3)
    ti.save_torch_file(ti.port_to_torch(G.state_dict(), ckpt.generator_entries(cfg)),
                       root / "step0-G.pt")
    torch.save(testing.torchcrepe_state_dict(4), root / "tiny.pth")
    train = [ln.split("|")[0] for ln in (data / "train_files").read_text().split()]
    test = [ln.split("|")[0] for ln in (data / "test_files").read_text().split()]
    pairs = [(f"pair{k}", test[k % 2], test[(k + 1) % 2]) for k in range(2)]
    pairs += [(f"pair{k + 2}", train[3 * k], test[k]) for k in range(2)]
    (data / "test_and_train").write_text((data / "train_files").read_text()
                                         + (data / "test_files").read_text())
    (data / "pairs").write_text("\n".join("|".join(p) for p in pairs) + "\n")
    return root


@pytest.fixture
def port_takes_jax_draws(monkeypatch):
    """The port's convert takes the JAX PRNG's draws for its seed; the JAX
    CLIs load G as ``generate_with_target.load_generator`` does, its init
    jitted."""

    def load_generator(cfg, load_path, epoch, num_spk):
        G = jax_generator(cfg.model.generator, num_spk)
        x = jnp.zeros((1, cfg.model.generator.total_ratio * 4, 1))
        pg = jax.jit(G.init)(jax.random.PRNGKey(0), x, jnp.eye(num_spk)[:1], None, x)
        pg, msg = jckpt.import_torch_generator(cfg, load_path / f"step{epoch}-G.pt", pg)
        assert not msg["missing_keys"] and not msg["mismatched_size"]
        return G, pg

    monkeypatch.setattr(jgen_cli, "load_generator", load_generator)
    convert = Converter.convert

    def with_jax_draws(self, signal, label_tgt, f0, mu_src, mu_tgt, seed=0, start_phase=None,
                       noise=None):
        padded, _ = self.pad_to_bucket(signal)
        start_phase, noise = jax_draws(seed, (1, padded.shape[-1]))
        return convert(self, signal, label_tgt, f0, mu_src, mu_tgt, seed, start_phase, noise)

    monkeypatch.setattr(Converter, "convert", with_jax_draws)


def same_wavs(out, ref, n_files):
    files = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in out.iterdir()) == files and len(files) == n_files
    for name in files:
        y, want = read(out / name), read(ref / name)
        assert y.shape == want.shape, name
        assert np.abs(y - want).max() <= AUDIO_ATOL, name
    return files


def test_generate_from_list(run, prepared, tmp_path, port_takes_jax_draws):
    args = ["--load_path", str(run), "--data_path", str(prepared["port"]), "--epoch", "0",
            "--data_file", "test_and_train", "--crepe_weights", str(run / "tiny.pth")]
    jfrom_list.main(args + ["--save_path", str(tmp_path / "jax")])
    generate_from_list.main(args + ["--save_path", str(tmp_path / "port"), "--device", "cpu"])
    files = same_wavs(tmp_path / "port", tmp_path / "jax", 4)
    assert files == [f"pair{k}.wav" for k in range(4)]


@pytest.mark.parametrize("pitch", ["zero excitation", "source pitch"])
def test_generate_from_dataset(run, prepared, tmp_path, port_takes_jax_draws, pitch):
    args = ["--load_path", str(run), "--data_path", str(prepared["port"]), "--epoch", "0",
            "--crepe_weights", str(run / "tiny.pth")]
    if pitch == "source pitch":
        args.append("--use_source_pitch")
    jfrom_dataset.main(args + ["--save_path", str(tmp_path / "jax")])
    generate_from_dataset.main(args + ["--save_path", str(tmp_path / "port"), "--device", "cpu"])
    # 2 test utterances to each of their 2 speakers, and the 2 originals
    files = same_wavs(tmp_path / "port", tmp_path / "jax", 6)
    assert sum(f.endswith("_conv.wav") for f in files) == 4


def test_get_model_info(tmp_path):
    """One run dir with step{E}-G.pt, the port's torch_state/epoch_{E}.pt and
    the JAX package's orbax/epoch_{E}, each epoch's files with one mtime (an
    outlier gap at epoch 3): both CLIs give the same dict."""
    (tmp_path / ckpt.STATE_DIR).mkdir()
    t0 = 1.7e9
    for e, t in enumerate((0, 600, 1230, 5000, 5590)):
        for p in (tmp_path / f"step{e}-G.pt", tmp_path / ckpt.STATE_DIR / f"epoch_{e}.pt"):
            p.write_bytes(b"")
            os.utime(p, (t0 + t, t0 + t))
        d = tmp_path / "orbax" / f"epoch_{e}"
        d.mkdir(parents=True)
        os.utime(d, (t0 + t, t0 + t))
    got, want = get_model_info.estimate_train_time(tmp_path), jinfo.estimate_train_time(tmp_path)
    assert got == want
    assert got["checkpoints"] == 10 and got["epoch_range"] == (0, 4)


def test_sample_f0(run, tmp_path, capsys):
    """f0_ratios.json of both CLIs on the same conv/orig pairs, with the
    same torchcrepe checkpoint, within F0_RTOL; the plot branch without
    matplotlib prints the JAX CLI's message."""
    t = np.arange(9600) / SR
    for phrase, (f_orig, f_conv) in {"001": (120, 180), "002": (200, 150)}.items():
        write_audio(tmp_path / f"{phrase}-p225-X-orig.wav", 0.3 * np.sin(2 * np.pi * f_orig * t),
                    SR)
        write_audio(tmp_path / f"{phrase}-p225-p226-conv.wav",
                    0.3 * np.sin(2 * np.pi * f_conv * t), SR)
    weights = ["--crepe_weights", str(run / "tiny.pth")]
    jsample_f0.main([str(tmp_path)] + weights)
    want = json.loads((tmp_path / "f0_ratios.json").read_text())
    (tmp_path / "f0_ratios.json").unlink()
    sample_f0.main([str(tmp_path), "--device", "cpu", "--out", str(tmp_path / "r.png")]
                   + weights)
    got = json.loads((tmp_path / "f0_ratios.json").read_text())
    assert set(got) == set(want) and len(got) == 2
    for name, row in want.items():
        for key, v in row.items():
            np.testing.assert_allclose(got[name][key], v, rtol=F0_RTOL, atol=0, err_msg=key)
    try:
        import matplotlib  # noqa: F401
        assert (tmp_path / "r.png").exists()
    except ImportError:
        assert "matplotlib unavailable; json written only" in capsys.readouterr().out


def test_conversion_clis_need_a_card_unless_asked_for_the_cpu(monkeypatch, run, prepared,
                                                              tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--save_path", str(tmp_path / "out"), "--load_path", str(run), "--data_path",
            str(prepared["port"])]
    for mod in (generate_from_list, generate_from_dataset):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_f0.main([str(tmp_path)])
    assert not (tmp_path / "out").exists() and not (tmp_path / "f0_ratios.json").exists()
