"""The port's host input pipeline against the JAX package's, on audio that
the tests write: FLAC and WAV I/O, the datasets (augmentation, crops,
corruption, precorrupted replay, pairs) and the prefetching iterator.

Tolerances: everything is bit-identical except the corrupted signal, which
the JAX package may filter with its C++ ``sosfilt`` and overlap-add
(td_vc_gan_tpu/native) where the port uses scipy's and numpy's; those agree
to ~1e-7 here, and the tests allow 1e-5 absolute.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from td_vc_gan_tpu.data import audio_io as jaudio
from td_vc_gan_tpu.data import corruption as jcorr
from td_vc_gan_tpu.data import dataset as jds
from td_vc_gan_tpu.data import flac as jflac
from td_vc_gan_tpu.data import pairs as jpairs
from td_vc_gan_tpu.ops import dsp as jdsp
from td_vc_gan_tpu_torch.data import audio_io as paudio
from td_vc_gan_tpu_torch.data import corruption as pcorr
from td_vc_gan_tpu_torch.data import dataset as pds
from td_vc_gan_tpu_torch.data import flac as pflac
from td_vc_gan_tpu_torch.data import pairs as ppairs
from td_vc_gan_tpu_torch.ops import dsp as pdsp

torch.set_num_threads(1)

SR = 16000
CORRUPT_ATOL = 1e-5


def tone(seed, n, f0=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = f0 or rng.uniform(100, 220)
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 5))
    return 0.2 * x + 0.01 * rng.standard_normal(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 speakers x 3 utterances of 0.5-1.2 s, WAV at 16 kHz, one FLAC per
    speaker and one 22.05 kHz WAV (resampled on read)."""
    root = tmp_path_factory.mktemp("port_data")
    rng = np.random.default_rng(0)
    entries = []
    for spk in range(3):
        for j in range(3):
            n = int(rng.uniform(0.5, 1.2) * SR)
            sig = tone(10 * spk + j, n)
            if j == 1:
                path = root / f"spk{spk}_{j}.flac"
                jflac.write_flac(path, sig, SR)
            elif j == 2 and spk == 0:
                path = root / f"spk{spk}_{j}.wav"
                jaudio.write_audio(path, tone(99, int(n * 22050 / SR)), 22050)
            else:
                path = root / f"spk{spk}_{j}.wav"
                jaudio.write_audio(path, sig, SR)
            entries.append(f"{path}|spk{spk}")
    (root / "train_files").write_text("\n".join(entries) + "\n")
    (root / "test_files").write_text("\n".join(entries[::4]) + "\n")
    with open(root / "speakers", "wb") as f:
        pickle.dump({f"spk{s}": s for s in range(3)}, f)
    return root


def test_flac_write_and_read_bit_identical(tmp_path):
    sig = tone(1, 9000)
    stereo = np.stack([sig, tone(2, 9000)], -1)
    for name, x in (("mono", sig), ("stereo", stereo), ("flat", np.zeros(300))):
        a, b = tmp_path / f"{name}_j.flac", tmp_path / f"{name}_p.flac"
        jflac.write_flac(a, x, SR)
        pflac.write_flac(b, x, SR)
        assert a.read_bytes() == b.read_bytes()
        (ja, jsr), (pa, psr) = jflac.read_flac(a), pflac.read_flac(a)
        assert jsr == psr == SR
        np.testing.assert_array_equal(ja, pa)


@pytest.mark.parametrize("target_sr", [None, SR, 8000, 24000])
def test_read_audio_bit_identical(corpus, target_sr):
    for line in (corpus / "train_files").read_text().split():
        path = line.split("|")[0]
        (ja, jsr), (pa, psr) = jaudio.read_audio(path, target_sr), paudio.read_audio(path, target_sr)
        assert jsr == psr
        np.testing.assert_array_equal(ja, pa)


def test_wav_meta_slice_and_write(tmp_path, corpus):
    path = str(corpus / "spk1_0.wav")
    jm, pm = jaudio.wav_meta(path), paudio.wav_meta(path)
    assert (jm.sr, jm.n_frames, jm.channels, jm.dtype, jm.data_offset) == (
        pm.sr, pm.n_frames, pm.channels, pm.dtype, pm.data_offset)
    np.testing.assert_array_equal(jaudio.read_wav_slice(path, jm, 100, 5000),
                                  paudio.read_wav_slice(path, pm, 100, 5000))
    x = 1.3 * tone(3, 4000)
    jaudio.write_audio(tmp_path / "j.wav", x, SR)
    paudio.write_audio(tmp_path / "p.wav", x, SR)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "p.wav").read_bytes()
    np.testing.assert_array_equal(jaudio.resample_fft(x, 3001), paudio.resample_fft(x, 3001))


def test_eq_rms_helpers():
    x, y = tone(4, 3000), 0.3 * tone(5, 3000)
    assert jdsp.eq_rms_gain(x, -30.0) == pdsp.eq_rms_gain(x, -30.0)
    np.testing.assert_array_equal(jdsp.eq_rms(x, -20.0), pdsp.eq_rms(x, -20.0))
    np.testing.assert_array_equal(jdsp.eq_rms_signals(x, y), pdsp.eq_rms_signals(x, y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corrupt(seed):
    wav = tone(20 + seed, 8960).astype(np.float32)
    want = jcorr.corrupt(wav, SR, np.random.default_rng(seed))
    got = pcorr.corrupt(wav, SR, np.random.default_rng(seed))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CORRUPT_ATOL)
    assert np.abs(got - wav).max() > 1e-3  # the corruption did change the signal


def test_psola_overlap_add_matches_numpy_fallback():
    rng = np.random.default_rng(6)
    wav = rng.standard_normal(2000).astype(np.float32)
    ana = np.sort(rng.integers(0, 2000, 30))
    pos = np.sort(rng.integers(0, 2200, 30))
    half = rng.integers(0, 80, 30)
    from td_vc_gan_tpu import native

    for a, b in zip(native.psola_ola(wav, ana, pos, half, 2100),
                    pcorr.psola_ola(wav, ana, pos, half, 2100)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _datasets(corpus, **kw):
    args = (corpus / "train_files", corpus / "speakers")
    return jds.WaveDataset(*args, **kw), pds.WaveDataset(*args, **kw)


def _same_item(a, b):
    assert set(a) == set(b)
    np.testing.assert_array_equal(a["signal"], b["signal"])
    assert a["label"] == b["label"] and a["label"].dtype == b["label"].dtype
    if "corrupted" in a:
        assert a["corrupted"].dtype == b["corrupted"].dtype
        np.testing.assert_allclose(a["corrupted"], b["corrupted"], rtol=0, atol=CORRUPT_ATOL)


TRAIN_KW = dict(sample_rate=SR, max_segment_size=5120, augment_noise=1e-9,
                normalization_db=-30.0, data_augment=True, corrupt=True, pad_to_max=True,
                seed=7)


def test_dataset_train_mode_items(corpus):
    """Augmentation, crop, pad_to_max and corruption for several (index,
    epoch); each item twice, so the second read takes the cached slice path."""
    jd, pd = _datasets(corpus, **TRAIN_KW)
    assert len(jd) == len(pd) == 9 and jd.num_spk == pd.num_spk
    for _ in range(2):
        for i, epoch in ((0, 0), (1, 0), (2, 1), (4, 3), (8, 2)):
            _same_item(jd.__getitem__(i, epoch), pd.__getitem__(i, epoch))


def test_dataset_test_mode_items(corpus):
    kw = dict(sample_rate=SR, max_segment_size=71680, normalization_db=-30.0, seed=7)
    jd, pd = _datasets(corpus, **kw)
    for i in range(len(jd)):
        _same_item(jd.__getitem__(i), pd.__getitem__(i))
    jd, pd = _datasets(corpus, sample_rate=SR, add_new_spks=True, normalization_db=None)
    _same_item(jd[3], pd[3])
    assert pd.get_filename(3) == jd.get_filename(3) and pd.get_label(3) == jd.get_label(3)


def test_train_iterator_two_epochs(corpus):
    jd, pd = _datasets(corpus, **TRAIN_KW)
    ji = jds.make_train_iterator(jd, 4, num_workers=2, prefetch=2, seed=7)
    pi = pds.make_train_iterator(pd, 4, num_workers=2, prefetch=2, seed=7)
    try:
        for _ in range(4):  # 2 steps per epoch, epochs 0 and 1
            (je, jb), (pe, pb) = next(ji), next(pi)
            assert je == pe
            assert set(jb) == set(pb) == {"signal", "label", "corrupted"}
            np.testing.assert_array_equal(jb["signal"], pb["signal"])
            np.testing.assert_array_equal(jb["label"], pb["label"])
            np.testing.assert_allclose(jb["corrupted"], pb["corrupted"], rtol=0,
                                       atol=CORRUPT_ATOL)
        assert pe == 1
    finally:
        ji.close()
        pi.close()
    np.testing.assert_array_equal(jds.collate([jd[0], jd[5]])["signal"],
                                  pds.collate([pd[0], pd[5]])["signal"])


def test_train_iterator_close_stops_its_workers(corpus):
    """The items are made in worker processes; ``close`` ends them and the
    fork server they were forked from, which would outlive this process."""
    import multiprocessing
    from multiprocessing import forkserver

    _, pd = _datasets(corpus, **TRAIN_KW)
    before = set(multiprocessing.active_children())
    it = pds.make_train_iterator(pd, 4, num_workers=2, prefetch=1, seed=7)
    epoch, batch = next(it)
    workers = set(multiprocessing.active_children()) - before
    server = forkserver._forkserver._forkserver_pid
    it.close()
    assert epoch == 0 and batch["signal"].shape == (4, TRAIN_KW["max_segment_size"])
    assert len(workers) == 2
    assert not any(w.is_alive() for w in workers)
    assert server is not None and not os.path.exists(f"/proc/{server}")


def test_train_iterator_raises_a_worker_error(corpus, tmp_path):
    """A file that cannot be read fails the next batch in the consumer,
    rather than leaving it waiting."""
    lines = (corpus / "train_files").read_text().split()
    (tmp_path / "train_files").write_text("\n".join(
        [f"{tmp_path / 'missing.wav'}|{lines[0].split('|')[1]}"] + lines[1:4]) + "\n")
    pd = pds.WaveDataset(tmp_path / "train_files", corpus / "speakers", **TRAIN_KW)
    it = pds.make_train_iterator(pd, 4, num_workers=1, prefetch=1, seed=7)
    try:
        with pytest.raises(RuntimeError, match="data pipeline failed"):
            next(it)
    finally:
        it.close()


def test_precorrupted_index(corpus, tmp_path):
    """Stored corruption variants are replayed (gain, flip, crop) alike."""
    index = {}
    for k, line in enumerate((corpus / "train_files").read_text().split()):
        path = line.split("|")[0]
        sig, _ = jaudio.read_audio(path, SR)
        variants = []
        for v in range(2):
            out = tmp_path / f"var{k}_{v}.wav"
            jaudio.write_audio(out, 0.5 * np.roll(sig, 37 * (v + 1)), SR)
            variants.append(str(out))
        index[path] = variants
    with open(tmp_path / "index.pkl", "wb") as f:
        pickle.dump(index, f)
    jd, pd = _datasets(corpus, **TRAIN_KW, precorrupted_index=tmp_path / "index.pkl")
    for _ in range(2):
        for i, epoch in ((0, 0), (3, 1), (7, 5)):
            a, b = jd.__getitem__(i, epoch), pd.__getitem__(i, epoch)
            _same_item(a, b)
            np.testing.assert_array_equal(a["corrupted"], b["corrupted"])


def test_pairs_dataset(corpus, tmp_path):
    lines = (corpus / "train_files").read_text().split()
    paths = [ln.split("|")[0] for ln in lines]
    (tmp_path / "pairs").write_text(f"c0|{paths[0]}|{paths[4]}\nc1|{paths[7]}|{paths[2]}\n")
    kw = dict(sample_rate=SR, max_segment_size=5120, normalization_db=-30.0, seed=3)
    args = (tmp_path / "pairs", corpus / "train_files", corpus / "speakers")
    jp, pp = jpairs.PairsDataset(*args, **kw), ppairs.PairsDataset(*args, **kw)
    assert len(jp) == len(pp) == 2
    for i in range(2):
        a, b = jp.__getitem__(i, 1), pp.__getitem__(i, 1)
        assert a["conv_name"] == b["conv_name"] == pp.get_convname(i)
        for k in ("source", "target"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[f"{k}_label"] == b[f"{k}_label"]
