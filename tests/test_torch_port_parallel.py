"""Data parallelism (``td_vc_gan_tpu_torch.parallel``) and the sharded
long-audio conversion, against the JAX package, on the CPU over gloo.

- A one-rank process group changes nothing: the step under it is
  bit-identical to the step without one, in f32 and in bf16.
- The collectives are exact over two ranks (two processes): the mean of
  gradients, the metrics' mean, the gather of per-item rows, the replica
  check and the barrier.
- The train CLI runs on two ranks (two processes, one gloo group): only
  rank 0 writes, and a resume restores the same state on both.
- ``Converter.convert_long_sharded`` against the JAX package's on a
  one-device mesh, with the JAX draws injected, within the JAX test's own
  tolerance (tests/test_inference.py: rtol 2e-4, atol 2e-5); and one device
  against two at a chunk count that two do not divide, within the same
  tolerance (each shard is a batch of another size).

The two-rank train step against the JAX step on the global batch is in
tests/test_torch_port_train_step.py, beside the JAX step it reuses.
"""

import copy
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu import parallel as jparallel
from td_vc_gan_tpu.cli import train as jax_train_cli
from td_vc_gan_tpu.inference import Converter as JaxConverter
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models.generator import Generator as JaxGenerator
from td_vc_gan_tpu_torch import parallel, testing, weights
from td_vc_gan_tpu_torch.cli import train as train_cli
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.data.audio_io import write_audio
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import Crepe, crepe_from_seed
from td_vc_gan_tpu_torch.models.discriminator import CollaborativeMultibandDiscriminator
from td_vc_gan_tpu_torch.models.generator import Generator
from td_vc_gan_tpu_torch.models.layers import init_weights
from td_vc_gan_tpu_torch.training import state as tstate
from td_vc_gan_tpu_torch.training import step as tstep

torch.set_num_threads(1)

RATIOS, CHANNELS = (10, 4, 2, 2), (16, 16, 8, 8, 4)
SEG = 1280
NUM_SPK = 4
# the JAX package's own sharding-invariance tolerance (tests/test_inference.py)
SHARD_TOL = dict(rtol=2e-4, atol=2e-5)


def tiny_cfg(compute_dtype: str) -> Config:
    cfg = Config()
    g = cfg.model.generator
    g.decoder_ratios, g.decoder_channels = list(RATIOS), list(CHANNELS)
    g.content_dim = g.conditional_dim = 8
    g.mrf_kernel_sizes, g.mrf_dilations = [3], [1]
    cfg.model.discriminator.num_channels_base = 4
    cfg.model.discriminator.num_layers = 2
    cfg.train.max_segment = SEG
    cfg.train.mel_fft_sizes = [512]
    cfg.train.compute_dtype = compute_dtype
    return cfg


def stepped_state(cfg, group) -> tuple:
    """One step of the tiny stage-2 step from seeded weights, under
    ``group``: (its metrics, state, the generator's state)."""
    G = init_weights(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, kernel_sizes=(3,),
                               dilations=(1,)), 1)
    D = init_weights(CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4,
                                                         num_layers=2), 2)
    state = tstate.create_train_state(cfg, G, D, None, crepe_from_seed(5))
    step = tstep.build_train_step(cfg, state, group)
    rng = np.random.default_rng(11)
    t = np.arange(SEG) / 16000
    sig = np.stack([0.2 * np.sin(2 * np.pi * (120 + 40 * i) * t) for i in range(4)])
    sig = (sig + 0.01 * rng.standard_normal(sig.shape)).astype(np.float32)
    batch = {"signal": torch.from_numpy(sig),
             "corrupted": torch.from_numpy(sig + np.float32(0.05)),
             "label": torch.arange(4) % NUM_SPK}
    gen = torch.Generator().manual_seed(3)
    return step(batch, gen), state, gen.get_state()


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{testing.free_port()}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_rank_group_is_bit_identical(one_rank_group, compute_dtype):
    """Every collective of the step runs (over one rank) and changes no
    bit: metrics, parameters, both Adam moments and the generator."""
    cfg = tiny_cfg(compute_dtype)
    m_none, s_none, gen_none = stepped_state(cfg, None)
    m_group, s_group, gen_group = stepped_state(copy.deepcopy(cfg), one_rank_group)
    assert set(m_none) == set(m_group)
    for k in m_none:
        assert torch.equal(m_none[k], m_group[k]), k
    for net in ("opt_g", "opt_d"):
        ua, ub = getattr(s_none, net), getattr(s_group, net)
        for p, q in zip(ua.params, ub.params):
            assert torch.equal(p, q)
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(ua.optimizer.state[p][key], ub.optimizer.state[q][key])
    assert torch.equal(gen_none, gen_group)


def test_collectives_are_exact_over_two_ranks():
    outs = testing.run_ranks(2, testing.call("td_vc_gan_tpu_torch.testing:collectives_probe"))
    assert [out.split()[-1] for out in outs] == ["ok", "ok"]


def test_batch_must_divide_by_the_ranks():
    """As the JAX loop: equal per-rank batches, else the mean of the ranks'
    batch means would not be the global mean."""
    assert parallel.local_batch(16, 4) == 4
    with pytest.raises(ValueError, match="must divide by the 3 ranks"):
        parallel.local_batch(16, 3)
    assert parallel.rank_world() == (0, 1)  # no process group here


@pytest.mark.parametrize("extra, fails", [
    ([], False),
    (["--num_processes", "1"], False),
    (["--num_processes", "2"], True),
    (["--num_processes", "2", "--process_id", "0"], True),
    (["--num_processes", "2", "--coordinator_address", "h:1"], True),
    (["--num_processes", "2", "--process_id", "1", "--coordinator_address", "h:1"], False),
])
def test_cli_parser_errors_match_jax(capsys, extra, fails):
    """The same argument lists fail, with the same message but for the name
    of the library that would not find the other processes."""
    argv = ["--save_path", "s", "--data_path", "d", *extra]
    got = []
    for parse in (jax_train_cli.parse_args, train_cli.parse_args):
        if fails:
            with pytest.raises(SystemExit) as err:
                parse(argv)
            assert err.value.code == 2
            got.append(capsys.readouterr().err.splitlines()[-1].split(" (")[0])
        else:
            args = parse(argv)
            got.append((args.num_processes, args.process_id, args.coordinator_address))
    assert got[0] == got[1]
    if fails:
        assert got[0].endswith("--num_processes > 1 requires --coordinator_address and "
                               "--process_id")


CLI_OVERRIDES = [
    "model.generator.encoder_model=conv",
    "model.generator.decoder_ratios=[10,4,2,2]",
    "model.generator.decoder_channels=[16,16,8,8,4]",
    "model.generator.content_dim=8",
    "model.generator.conditional_dim=8",
    "model.generator.num_enc_layers=2",
    "model.generator.mrf_kernel_sizes=[3]",
    "model.generator.mrf_dilations=[1]",
    "model.discriminator.num_channels_base=4",
    "model.discriminator.num_layers=2",
    "train.batch_size=4",  # global: 2 per rank, 2 steps per epoch on 4 files each
    "train.num_epoch=0",
    "train.max_segment=1280",
    "train.mel_fft_sizes=[512]",
    "train.num_workers=1",
    "test.max_segment=1280",
    "test.num_tests=1",
    "log.gen_num=1",
    "log.save_interval=1",
    "log.gen_interval=1",
    "log.val_interval=1",
    "log.log_interval=1",
]


def test_train_cli_on_two_ranks(tmp_path, monkeypatch):
    """Epoch 0 (2 steps of 2 items on each rank, validation, a save and a
    sample), then a resume for one more step. Only rank 0 writes or logs
    steps; both ranks serve their half of the manifest, end, and resume the
    state rank 0 saved. One OpenMP thread per rank: ranks that share the
    CPU's cores and wait on each other at every collective otherwise spin
    against each other (25 s a step instead of 1.5)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rng = np.random.default_rng(0)
    entries = []
    for spk in range(2):
        for j in range(4):
            t = np.arange(4800) / 16000
            sig = 0.25 * np.sin(2 * np.pi * (120 + 60 * spk + 15 * j) * t) * (
                1 + 0.05 * rng.standard_normal(t.size))
            write_audio(tmp_path / f"p{spk}_{j:03d}.wav", sig, 16000)
            entries.append(f"{tmp_path / f'p{spk}_{j:03d}.wav'}|p{spk}")
    (tmp_path / "train_files").write_text("\n".join(entries) + "\n")
    (tmp_path / "test_files").write_text(f"{entries[1]}\n")
    with open(tmp_path / "speakers", "wb") as f:
        pickle.dump([("p0", 0), ("p1", 1)], f)
    run = tmp_path / "run"

    def command(extra):
        return lambda rank, world, address: [
            sys.executable, "-m", "td_vc_gan_tpu_torch.cli.train", "--save_path", str(run),
            "--data_path", str(tmp_path), "--device", "cpu", "--num_processes", str(world),
            "--process_id", str(rank), "--coordinator_address", address,
            *[a for o in CLI_OVERRIDES for a in ("--override", o)], *extra]

    first = [out.splitlines() for out in testing.run_ranks(2, command([]))]
    for rank, lines in enumerate(first):
        assert f"[host {rank}/2] serving 4 of the manifest, local batch 2" in lines
        assert any(ln.startswith(f"[rank {rank}/2] Done at step 2:") for ln in lines)
    steps = [ln for ln in first[0] if ln.startswith("Epoch ")]
    assert [re.search(r"Itt (\d+)", s).group(1) for s in steps] == ["0", "1"]
    assert any(ln.startswith("2 ranks start from the same train state") for ln in first[0])
    saved = [re.search(r"digest (\w+)", ln).group(1) for ln in first[0]
             if ln.startswith("Saved epoch 0")]
    assert len(saved) == 1
    assert not any(re.match(r"(Epoch|Val|Sav)", ln) for ln in first[1])
    # what rank 0 wrote, once
    assert "--process_id 0" in (run / "argv").read_text()
    for name in ("config.yaml", "torch_state/epoch_0.pt", "step0-G.pt", "step0-D.pt"):
        assert (run / name).exists(), name
    assert len(list((run / "generated").iterdir())) == 3  # one sample: conv, orig, rec

    second = [out.splitlines() for out in testing.run_ranks(
        2, command(["--load_path", str(run), "--override", "train.num_epoch=1",
                    "--max_steps", "3"]))]
    for rank, lines in enumerate(second):
        assert any(ln.startswith(f"[rank {rank}/2] Resumed train state epoch 0 (step 2, "
                                 f"digest {saved[0]}") for ln in lines), lines
        assert any(ln.startswith(f"[rank {rank}/2] Done at step 3:") for ln in lines)
    assert [re.search(r"Itt (\d+)", s).group(1) for s in second[0]
            if s.startswith("Epoch ")] == ["2"]


@pytest.fixture(scope="module")
def converters():
    """The JAX Converter and the port's (tests/test_torch_port_convert.py's
    small generator) with the same weights."""
    g = JaxGenerator(decoder_ratios=RATIOS, decoder_channels=CHANNELS,
                     num_bottleneck_layers=0, num_classes=4, conditional_dim=8,
                     content_dim=8, kernel_sizes=(3,), dilations=(1,))
    x = jnp.zeros((1, 1280, 1))
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(g.init, jax.random.PRNGKey(0), x, jnp.zeros((1, 4)), None, x)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "'g'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return ((0.1 if "bias" in name else 0.3) * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    crepe_params = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    jconv = JaxConverter(jcfg.Config(), g, params, crepe_params, decoder="viterbi")
    port_g = weights.generator_from_jax(
        Generator(RATIOS, CHANNELS, 4, 8, 8, kernel_sizes=(3,), dilations=(1,)), params)
    port_crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray,
                                                                             crepe_params))
    return jconv, Converter(Config(), port_g, port_crepe, decoder="viterbi", device="cpu")


def long_signal(n: int) -> np.ndarray:
    t = np.arange(n) / 16000
    return (0.2 * np.sin(2 * np.pi * (150 + 40 * t) * t)).astype(np.float32)


def test_convert_long_sharded_matches_jax(converters):
    """7 chunks on a one-device mesh; the JAX path draws one (7, chunk)
    noise tensor and one start phase from the key of ``seed``, and chunk i
    takes row i of it."""
    jconv, conv = converters
    sig = long_signal(17000)
    kw = dict(chunk=3840, overlap=1280, seed=3)
    want = jconv.convert_long_sharded(sig, 2, np.log(220.0), jparallel.create_mesh(1), **kw)
    k_phase, k_noise = jax.random.split(jax.random.PRNGKey(3))
    start = float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi)
    noise = np.asarray(jax.random.normal(k_noise, (7, 3840)))
    got = conv.convert_long_sharded(sig, 2, np.log(220.0), ["cpu"],
                                    draws=[(start, noise[i:i + 1]) for i in range(7)], **kw)
    assert got.shape == sig.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SHARD_TOL)


def test_convert_long_sharded_is_device_count_invariant(converters):
    """7 chunks on one device, and on two (8 rows, the last a pad); each
    chunk draws from seed + i. Short inputs go to convert_long."""
    _, conv = converters
    sig = long_signal(17000)
    kw = dict(chunk=3840, overlap=1280, seed=3)
    one = conv.convert_long_sharded(sig, 1, np.log(200.0), ["cpu"], **kw)
    two = conv.convert_long_sharded(sig, 1, np.log(200.0), ["cpu", "cpu"], **kw)
    assert np.isfinite(one).all() and np.abs(one).max() > 0
    np.testing.assert_allclose(two, one, **SHARD_TOL)
    short = long_signal(3000)
    np.testing.assert_array_equal(
        conv.convert_long_sharded(short, 1, np.log(200.0), ["cpu", "cpu"], **kw),
        conv.convert_long(short, 1, np.log(200.0), 3840, 1280, 3))
