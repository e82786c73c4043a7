"""The port's checkpoints against the JAX package's: the reference ``.pt``
format in both directions, ``load_possible``, the full train state, the
torchcrepe loader; and the small pieces of the slice held against JAX
(MultiscaleDiscriminator, ``_pad_bucket``, ``parse_fn``, the override parser).

Weights are made with numpy from a seed in the flax trees' shapes. Exported
files are compared key for key and bit for bit; generator outputs within
1e-5 of max|ref| (f32 on both sides, sums in another order).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.cli import generate_with_target as jgen_cli
from td_vc_gan_tpu.models import discriminator as jd
from td_vc_gan_tpu.training import checkpoint as jckpt
from td_vc_gan_tpu.training import loop as jloop
from td_vc_gan_tpu.training import torch_import as jtorch_import
from td_vc_gan_tpu_torch import testing, weights
from td_vc_gan_tpu_torch.cli import generate_with_target as pgen_cli
from td_vc_gan_tpu_torch.config import load_config, parse_override_value, parse_overrides
from td_vc_gan_tpu_torch.models import discriminator as pd
from td_vc_gan_tpu_torch.models.crepe import Crepe
from td_vc_gan_tpu_torch.training import checkpoint as pckpt
from td_vc_gan_tpu_torch.training import loop as ploop
from td_vc_gan_tpu_torch.training import torch_import as ptorch_import
from td_vc_gan_tpu_torch.training.state import create_train_state
from td_vc_gan_tpu_torch.training.step import build_train_step

torch.set_num_threads(1)

NUM_SPK = 3
SEG = 1280
G_RTOL = 1e-5  # generator outputs, of max|ref|

TINY = {
    "model": {"generator": {"decoder_ratios": [10, 4, 2, 2],
                            "decoder_channels": [16, 16, 8, 8, 4],
                            "content_dim": 8, "conditional_dim": 8,
                            "mrf_kernel_sizes": [3], "mrf_dilations": [1, 3]},
              "discriminator": {"num_channels_base": 4, "num_layers": 2}},
    "train": {"max_segment": SEG, "mel_fft_sizes": [512], "batch_size": 2},
    "log": {"val_lat_cls": True},
}


def fill(shapes, seed):
    """numpy leaves for a tree of shapes: gains in [0.5, 1.5], biases
    ~ 0.1 N(0, 1), other kernels ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "'g'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return ((0.1 if "bias" in name else 0.3) * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def models():
    """The JAX G, D, C with numpy-filled parameters, and the port's with
    the same weights."""
    jc, pc = jcfg.load_config(None, TINY), load_config(None, TINY)
    G, D, C = jloop.build_models(jc, NUM_SPK)
    x = jnp.zeros((1, SEG, 1))
    key = jax.random.PRNGKey(0)
    pg = fill(jax.eval_shape(G.init, key, x, jnp.zeros((1, NUM_SPK)), None, x), 1)
    pdp = fill(jax.eval_shape(D.init, key, x, jnp.zeros((1,), jnp.int32),
                              D.get_subsamples(x, 3)), 2)
    pcl = fill(jax.eval_shape(C.init, key, jnp.zeros((1, SEG // 160, 8))), 3)
    tG, tD, tC = ploop.build_models(pc, NUM_SPK, "cpu", seed=11)
    weights.generator_from_jax(tG, pg)
    weights.discriminator_from_jax(tD, pdp)
    weights.classifier_from_jax(tC, pcl)
    return SimpleNamespace(jc=jc, pc=pc, G=G, pg=pg, pd=pdp, pcl=pcl, tG=tG, tD=tD, tC=tC)


def test_export_matches_jax_flax_to_torch(models, tmp_path):
    """step{E}-{G,D,C}.pt, latest-*.pt and latest_epoch as the JAX package
    writes them for the same weights, key for key and bit for bit."""
    m = models
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jckpt.export_torch(SimpleNamespace(params_g=m.pg, params_d=m.pd, params_c=m.pcl), m.jc,
                       tmp_path / "jax", 4)
    pckpt.export_torch(SimpleNamespace(G=m.tG, D=m.tD, C=m.tC), m.pc, tmp_path / "port", 4)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "step4-C.pt" in names and "latest-G.pt" in names
    assert (tmp_path / "port" / "latest_epoch").read_text() == "4"
    for name in names:
        if not name.endswith(".pt"):
            continue
        a = torch.load(tmp_path / "jax" / name, weights_only=False)
        b = torch.load(tmp_path / "port" / name, weights_only=False)
        assert list(a) == list(b), name
        for k in a:
            assert a[k].dtype == b[k].dtype == torch.float32 and a[k].is_contiguous()
            assert torch.equal(a[k], b[k]), (name, k)


def _g_outputs(models, tG):
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, SEG, 1))).astype(np.float32)
    onehot = np.eye(NUM_SPK, dtype=np.float32)[[1, 2]]
    exc = (0.1 * rng.standard_normal((2, SEG, 1))).astype(np.float32)
    with torch.no_grad():
        got = tG(torch.from_numpy(x), torch.from_numpy(onehot), torch.from_numpy(exc))[0]
    return x, onehot, exc, got.numpy()


def test_import_jax_exported_generator(models, tmp_path):
    """A JAX-exported step0-G.pt into a fresh port G: the JAX weights
    exactly, and G's output within G_RTOL of max|ref| of the JAX G."""
    m = models
    jckpt.export_torch(SimpleNamespace(params_g=m.pg, params_d=m.pd, params_c=None), m.jc,
                       tmp_path, 0)
    tG, tD, _ = ploop.build_models(m.pc, NUM_SPK, "cpu", seed=99)
    msg = pckpt.import_torch_generator(m.pc, tmp_path / "step0-G.pt", tG)
    assert len(msg["matched"]) == len(tG.state_dict())
    assert not (msg["mismatched_size"] or msg["unmatched_keys"] or msg["missing_keys"])
    for k, v in tG.state_dict().items():
        assert torch.equal(v, m.tG.state_dict()[k]), k
    pckpt.import_torch_discriminator(m.pc, tmp_path / "step0-D.pt", tD)
    for k, v in tD.state_dict().items():
        assert torch.equal(v, m.tD.state_dict()[k]), k
    x, onehot, exc, got = _g_outputs(m, tG)
    want = np.asarray(jax.jit(m.G.apply)(m.pg, x, onehot, None, exc)[0])
    assert np.abs(got - want).max() <= G_RTOL * np.abs(want).max()


def test_load_possible_matches_jax():
    rng = np.random.default_rng(8)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    old = {"enc": {"conv": {"v": a(3, 2, 4), "g": a(4)}, "proj": {"kernel": a(2, 5)}},
           "dec": {"bias": a(6)}}
    new = {"enc": {"conv": {"v": a(3, 2, 4), "g": a(6)}, "proj": {"kernel": a(1, 7)}},
           "extra": {"w": a(2)}}
    merged, msg = jckpt.load_possible({"params": old}, {"params": new})

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
        return out

    pmerged, pmsg = pckpt.load_possible(flat(old), flat(new))
    for key in msg:
        assert sorted(pmsg[key]) == sorted(msg[key]), key
    fm = flat(merged["params"])
    assert sorted(fm) == sorted(pmerged)
    for k in fm:
        np.testing.assert_array_equal(pmerged[k], np.asarray(fm[k]))


def _tiny_batch(seed):
    rng = np.random.default_rng(seed)
    sig = (0.2 * rng.standard_normal((2, SEG))).astype(np.float32)
    return {"signal": torch.from_numpy(sig),
            "corrupted": torch.from_numpy(sig + 0.05 * rng.standard_normal(sig.shape)
                                          .astype(np.float32)),
            "label": torch.tensor([0, 2])}


def _tiny_state(cfg, seed):
    G, D, C = ploop.build_models(cfg, NUM_SPK, "cpu", seed=seed)
    return create_train_state(cfg, G, D, C, ploop.build_crepe(cfg, device="cpu"))


def test_full_state_save_restore_then_step(tmp_path):
    """Save after one step, restore into a state built from other seeds, take
    one step on both: bit for bit the same as without the save."""
    cfg = load_config(None, TINY)
    a = _tiny_state(cfg, seed=1)
    build_train_step(cfg, a)(_tiny_batch(1), torch.Generator().manual_seed(1))
    pckpt.save_state(a, tmp_path, 3)
    digest = ploop.state_digest(a)
    assert pckpt.latest_epoch(tmp_path) == 3 and pckpt.has_state(tmp_path, 3)
    b = _tiny_state(cfg, seed=2)
    assert ploop.state_digest(b) != digest
    pckpt.restore_state(b, tmp_path)
    assert ploop.state_digest(b) == digest and b.step == a.step == 1
    ma = build_train_step(cfg, a)(_tiny_batch(2), torch.Generator().manual_seed(5))
    mb = build_train_step(cfg, b)(_tiny_batch(2), torch.Generator().manual_seed(5))
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert ploop.state_digest(a) == ploop.state_digest(b)


def test_load_torchcrepe(tmp_path):
    """A torchcrepe-layout state dict written here, through both loaders:
    the same weights, and the same activations."""
    sd = testing.torchcrepe_state_dict(9)
    rng = np.random.default_rng(9)
    torch.save(sd, tmp_path / "tiny.pth")
    got = ptorch_import.load_torchcrepe(tmp_path / "tiny.pth")
    want = weights.crepe_from_jax(Crepe("tiny"), jtorch_import.load_torchcrepe(tmp_path / "tiny.pth"))
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    frames = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(got(frames), want(frames))


def test_multiscale_discriminator():
    x = (0.3 * np.random.default_rng(10).standard_normal((2, 2560, 1))).astype(np.float32)
    labels = np.array([1, 3], np.int32)
    mod = jd.MultiscaleDiscriminator(num_disc=3, num_classes=4, num_layers=2,
                                     num_channels_base=4)
    params = fill(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x, labels), 11)
    outs, feats = jax.jit(mod.apply)(params, x, labels)
    port = weights.discriminator_from_jax(
        pd.MultiscaleDiscriminator(3, 4, num_layers=2, num_channels_base=4), params)
    with torch.no_grad():
        pouts, pfeats = port(torch.from_numpy(x), torch.from_numpy(labels))
    assert len(pouts) == len(outs) == 3
    for a, b in zip(pouts, outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    for fa, fb in zip(pfeats, feats):
        for a, b in zip(fa, fb):
            np.testing.assert_allclose(a.numpy().transpose(0, 2, 1), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,cap", [(100, 71680), (8960, 71680), (8961, 71680),
                                   (90000, 71680), (5000, 5120), (6400, 5120)])
def test_pad_bucket(n, cap):
    sig = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want, got = jloop._pad_bucket(sig, cap), ploop._pad_bucket(sig, cap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,fmt", [("/d/p225_003.wav", "vctk"), ("x/s01-0042.wav", "alcaim"),
                                      ("list123.wav", "smt"), ("a/b/utt.flac", "other")])
def test_parse_fn(name, fmt):
    assert pgen_cli.parse_fn(name, fmt) == jgen_cli.parse_fn(name, fmt)


# every --override value the port's tests and chip_smoke.py pass
OVERRIDE_VALUES = ["[10,4,2,2]", "[16,16,8,8,4]", "8", "[3]", "[1,3]", "4", "1", "2",
                   "5120", "[512]", "true", "false", "null", "0", "16", "8960", "conv",
                   "[]", "0.0001", "1234"]


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_override_parser_matches_yaml(text):
    assert parse_override_value(text) == yaml.safe_load(text)


def test_parse_overrides():
    want = {"train": {"batch_size": 4, "mel_fft_sizes": [512]},
            "model": {"generator": {"encoder_model": "conv"}}}
    assert parse_overrides(["train.batch_size=4", "train.mel_fft_sizes=[512]",
                            "model.generator.encoder_model=conv"]) == want
    with pytest.raises(ValueError):
        parse_overrides(["train.batch_size"])
