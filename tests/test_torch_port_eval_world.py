"""The port's WORLD analysis, exact DTW and MCD protocol against the JAX
package's (``td_vc_gan_tpu/eval/world.py``, ``native.dtw``, ``eval/mcd.py``),
on seeded signals the test makes.

Tolerances: the WORLD stages (dio, stonemask, cheaptrick, sp2mc,
world_analyze) within 1e-9 relative (the port runs the same numpy, with
freqt as a numpy recursion where the JAX package calls its C++ library);
freqt within 1e-12 of the C++ one; the DTW's cost and path identical (the
JAX package's ``native.dtw`` is its C++ library when it builds, its numpy
loop otherwise); the MCD pickles equal, NaNs in the same places.
"""

import pickle

import numpy as np
import pytest
import torch

from td_vc_gan_tpu import native
from td_vc_gan_tpu.data.audio_io import write_audio
from td_vc_gan_tpu.eval import mcd as jmcd
from td_vc_gan_tpu.eval import world as jworld
from td_vc_gan_tpu_torch.eval import dtw as pdtw
from td_vc_gan_tpu_torch.eval import mcd
from td_vc_gan_tpu_torch.eval import world

torch.set_num_threads(1)

SR = 16000
WORLD_RTOL = 1e-9
FREQT_ATOL = 1e-12


def voiced(f0: float, seconds: float = 1.0, seed: int = 0, vibrato: float = 0.0):
    """A harmonic stack with a slow vibrato and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    inst = f0 * (1 + vibrato * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    return 0.2 * x + 0.01 * rng.standard_normal(t.size)


SIGNALS = {
    "steady": voiced(140.0, seed=1),
    "vibrato": voiced(220.0, seed=2, vibrato=0.03),
    "noise": 0.1 * np.random.default_rng(3).standard_normal(SR),
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_world_stages(name):
    x = SIGNALS[name]
    f0, times = world.dio(x, SR)
    want_f0, want_times = jworld.dio(x, SR)
    np.testing.assert_array_equal(times, want_times)
    np.testing.assert_allclose(f0, want_f0, rtol=WORLD_RTOL, atol=0)
    refined = world.stonemask(x, SR, times, f0)
    np.testing.assert_allclose(refined, jworld.stonemask(x, SR, times, f0),
                               rtol=WORLD_RTOL, atol=0)
    sp = world.cheaptrick(x, SR, times, refined)
    np.testing.assert_allclose(sp, jworld.cheaptrick(x, SR, times, refined),
                               rtol=WORLD_RTOL, atol=0)
    np.testing.assert_allclose(world.sp2mc(sp), jworld.sp2mc(sp), rtol=WORLD_RTOL,
                               atol=FREQT_ATOL)
    mcep, f0_all = world.world_analyze(x, SR)
    want_mcep, want_f0_all = jworld.world_analyze(x, SR)
    np.testing.assert_allclose(mcep, want_mcep, rtol=WORLD_RTOL, atol=FREQT_ATOL)
    np.testing.assert_allclose(f0_all, want_f0_all, rtol=WORLD_RTOL, atol=0)
    if name == "noise":
        assert (f0_all == 0).mean() > 0.5
    else:
        assert (f0_all > 0).mean() > 0.5


@pytest.mark.parametrize("order,alpha", [(24, 0.42), (64, -0.42), (0, 0.3)])
def test_freqt_matches_native(order, alpha):
    c = np.random.default_rng(order).standard_normal((7, 1024))
    np.testing.assert_allclose(world.freqt(c, order, alpha), native.freqt(c, order, alpha),
                               rtol=0, atol=FREQT_ATOL)
    np.testing.assert_allclose(world.freqt(c[0], order, alpha),
                               native.freqt(c[:1], order, alpha)[0], rtol=0, atol=FREQT_ATOL)


def dtw_cases():
    rng = np.random.default_rng(5)
    yield "random", rng.random((37, 52))
    yield "random_f32", rng.random((64, 48)).astype(np.float32)
    yield "ties", rng.integers(0, 3, (29, 31)).astype(np.float64)  # many equal sums
    yield "all_equal", np.ones((9, 12))
    yield "1xm", rng.random((1, 17))
    yield "nx1", rng.random((13, 1))
    yield "1x1", rng.random((1, 1))
    yield "f64_rounding", 1 + 1e-9 * rng.random((20, 20))  # equal once rounded to f32


@pytest.mark.parametrize("name,dist", list(dtw_cases()), ids=[c[0] for c in dtw_cases()])
def test_dtw_identical(name, dist):
    cost, path = pdtw.dtw(dist)
    want_cost, want_path = native.dtw(dist)
    assert cost == want_cost
    assert path.dtype == np.int32 and path.shape[1] == 2
    np.testing.assert_array_equal(path, want_path)
    assert tuple(path[0]) == (0, 0) and tuple(path[-1]) == (dist.shape[0] - 1, dist.shape[1] - 1)


def test_dtw_on_mel_cepstra():
    """The distance matrix of two analyses, as ``mcd_from_mceps`` builds it."""
    a = mcd.world_mcep(SIGNALS["steady"])[0]
    b = mcd.world_mcep(SIGNALS["vibrato"])[0]
    assert mcd.mcd_from_mceps(a, b) == jmcd.mcd_from_mceps(a, b)
    assert np.isfinite(mcd.mcd_from_mceps(a, b))


@pytest.fixture(scope="module")
def signals_dir(tmp_path_factory):
    """Two phrases by 3 speakers (originals) and their conversions, one of
    them to noise (too few voiced frames: NaN), one phrase without a target
    original, and a file no parse_fn takes."""
    d = tmp_path_factory.mktemp("mcd_signals")
    spk = {"sa": 110.0, "sb": 150.0, "sc": 210.0}
    for p, phrase in enumerate(("001", "002")):
        for s, (name, f0) in enumerate(spk.items()):
            write_audio(d / f"{phrase}-{name}-X-orig.wav",
                        voiced(f0 * (1 + 0.05 * p), 0.8, seed=10 * p + s), SR)
            for t, (tgt, f0t) in enumerate(spk.items()):
                sig = voiced(f0t, 0.8, seed=100 + 10 * p + 3 * s + t, vibrato=0.02)
                if (phrase, name, tgt) == ("002", "sc", "sa"):
                    sig = 0.05 * np.random.default_rng(7).standard_normal(sig.size)
                write_audio(d / f"{phrase}-{name}-{tgt}-conv.wav", sig, SR)
    write_audio(d / "003-sa-sb-conv.wav", voiced(150.0, 0.8, seed=9), SR)
    write_audio(d / "readme.wav", voiced(150.0, 0.3, seed=8), SR)
    return d


def same_nested(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same_nested(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_nested(g, w)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=WORLD_RTOL, atol=0)


def test_mcd_protocol_pickles(signals_dir, tmp_path):
    got = mcd.test_mcd(tmp_path / "port", signals_dir)
    want = jmcd.test_mcd(tmp_path / "jax", signals_dir)
    same_nested(got, want)
    with open(tmp_path / "port", "rb") as f:
        same_nested(pickle.load(f), want)
    conv = got["mcd_result_conv"]
    assert np.isnan(conv["sc"]["sa"][1]) and np.isfinite(conv["sa"]["sb"]).all()
    assert len(conv["sa"]["sb"]) == 2  # phrase 003 has no target original
    assert all(abs(v) < 1e-3 for v in got["mcd_result_orig"]["sb"]["sb"])  # itself


def test_compute_mcd():
    a, b = SIGNALS["steady"], SIGNALS["vibrato"]
    got, want = mcd.compute_mcd(a, b), jmcd.compute_mcd(a, b)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want],
                               rtol=WORLD_RTOL, atol=0)
