"""One train step of the port against the JAX package's at wavlm-stage1's
settings (W1), and the eval step at them, with the conv encoder as the JAX
suite runs them (tests/test_train_step.py:145-149).

W1: no_conv True, lambda_rec 0 (tests/test_config.py:26-28), lambda_idt 20,
with lambda_f0 10 and lambda_cont_emb 1 kept on, so that the no_conv pitch
targets (the source's own F0 and CREPE activations, step.py:60) and the
contrastive loss on the corrupted batch are held too, and jitter_amp 40
(the value of tests/test_torch_port_losses.py:171). With no_conv the target
is the source (perm = arange), G decodes once at B, and the identity pass is
the conversion pass, its D features reused from the adversarial part
(step.py:348-355, :403-409).

Tolerances and draws as tests/test_torch_port_stage1_step.py, which holds
S1 the same way; the jitter shifts are the JAX step's k_jit draw. The whole
JAX step is compiled once, in this file of its own; the eval step is held
through its pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_stage1_step import check_first_moments, check_metrics, check_parameters, \
    step_both
from test_torch_port_train_step import B, CHANNELS, MRF, NUM_SPK, RATIOS, SEG, configs, \
    make_batch, random_params

from td_vc_gan_tpu.models import CollaborativeMultibandDiscriminator as JaxD
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models.generator import Generator as JaxG
from td_vc_gan_tpu.ops import dsp as jdsp
from td_vc_gan_tpu.ops import losses as jl
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models import crepe as crepe_mod
from td_vc_gan_tpu_torch.models.crepe import Crepe, crepe_from_seed
from td_vc_gan_tpu_torch.models.discriminator import CollaborativeMultibandDiscriminator
from td_vc_gan_tpu_torch.models.generator import Generator
from td_vc_gan_tpu_torch.training import state as tstate
from td_vc_gan_tpu_torch.training import step as tstep

torch.set_num_threads(1)

METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
# wavlm-stage1's settings, on the conv encoder
W1 = dict(no_conv=True, lambda_rec=0.0, lambda_idt=20.0, lambda_f0=10.0,
          lambda_cont_emb=1.0, jitter_amp=40)


@pytest.fixture(scope="module")
def stepped():
    return step_both(W1)


def test_w1_metrics_match(stepped):
    check_metrics(stepped)
    m = stepped["metrics"]
    assert "C_loss" not in m and m["G_loss_lat_cls"] == 0.0 and m["G_loss_rec"] == 0.0
    for key in ("G_loss_idt", "G_loss_idt_feat", "G_loss_idt_spec", "G_loss_cont_emb"):
        assert m[key] > 0, key
    # the identity target is the source itself: the activations' own target
    # leaves an f0 loss of G's output only, finite and positive
    assert 0 < m["g_loss_f0"] < np.inf


@pytest.mark.parametrize("net", ["G", "D"])
def test_w1_first_moments_match(stepped, net):
    check_first_moments(stepped, net)


@pytest.mark.parametrize("net", ["G", "D"])
def test_w1_updated_parameters_match(stepped, net):
    check_parameters(stepped, net)


def test_w1_pitch_targets_are_the_source():
    """compute_pitch_features with no_conv: f0_conv is f0_src and the
    activation target is the source's own, unshifted, whatever perm says."""
    crepe = crepe_from_seed(5)
    sig = torch.from_numpy(make_batch()["signal"])
    perm = torch.tensor([3, 2, 1, 0])
    pf = tstep.compute_pitch_features(crepe, sig, perm, 16000, True, {},
                                      torch.Generator().manual_seed(0))
    f0, act = crepe_mod.filtered_pitch(crepe, sig)
    assert torch.equal(pf["f0_conv"], f0) and torch.equal(pf["f0_src"], f0)
    assert torch.equal(pf["act_conv_tgt"], act)


def test_w1_eval_step_pieces():
    """build_eval_step at W1 against the JAX modules applied as
    ``build_eval_step`` applies them: label_tgt = label_src (no draw), the
    excitation of the source's F0 from k_exc; no latent classifier."""
    jax_cfg, cfg = configs()
    for k, v in W1.items():
        setattr(cfg.train, k, v)
    G = JaxG(decoder_ratios=RATIOS, decoder_channels=CHANNELS, num_bottleneck_layers=0,
             num_classes=NUM_SPK, conditional_dim=8, content_dim=8, **MRF)
    D = JaxD(num_disc=3, num_classes=NUM_SPK, num_channels_base=4)
    x0 = jnp.zeros((1, SEG, 1))
    pg = random_params(G, x0, jnp.zeros((1, NUM_SPK)), None, x0, seed=6)
    pd = random_params(D, x0, jnp.zeros((1,), jnp.int32), (), seed=7)
    cp = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    batch = make_batch()
    x = batch["signal"][..., None]
    _, k_exc = jax.random.split(jax.random.PRNGKey(8))
    label = batch["label"]
    f0, _ = jax.jit(jcrepe.filtered_pitch)(cp, batch["signal"])
    exc = jdsp.f0_to_excitation(f0, 64, k_exc)[..., None]
    fake, _, _ = jax.jit(G.apply)(pg, x, jax.nn.one_hot(label, NUM_SPK), None, exc)
    d_apply = jax.jit(lambda p, x, lab: D.apply(p, x, lab, ())[0])
    out_real, out_fake = d_apply(pd, x, label), d_apply(pd, fake, label)
    l_real, l_fake, _, _ = jl.lsgan_d_loss(out_real, out_fake)
    want = {"val_loss_adv_real": l_real, "val_loss_adv_fake": l_fake,
            "val_D_loss": l_real + l_fake, "val_G_loss": jl.lsgan_g_loss(out_fake)[0]}

    tG = weights.generator_from_jax(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), pg)
    tD = weights.discriminator_from_jax(
        CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), pd)
    crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray, cp))
    state = tstate.create_train_state(cfg, tG, tD, None, crepe)
    k_phase, k_noise = jax.random.split(k_exc)
    # a label_tgt draw is ignored under no_conv: the target is the source
    draws = dict(label_tgt=(label + 1) % NUM_SPK,
                 exc=(float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi),
                      np.asarray(jax.random.normal(k_noise, (B, SEG)))))
    got = tstep.build_eval_step(cfg, state)({k: torch.from_numpy(v) for k, v in batch.items()},
                                            draws=draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **METRIC_TOL)
