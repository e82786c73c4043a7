"""One bf16 train step (``train.compute_dtype: bfloat16``) of the port
against the JAX package's, at the tiny configuration of
tests/test_torch_port_train_step.py (SEG 1280, batch 4, the stage-2 loss
weights), with the same parameters, batch and random draws.

The whole JAX step is compiled once, in bf16, in this file of its own. The
size of bf16's error comes from the port's own f32 step, which the f32 test
holds within 1e-4 of the JAX f32 step's metrics: for each metric,

    |port_bf16 - jax_bf16| / |jax_bf16|
        <= 2 * max over the metrics of |jax_bf16 - port_f32| / |port_f32| + 1e-4.

After the step the parameters, their gradients and AdamW's moments are f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import B, CHANNELS, MRF, NUM_SPK, RATIOS, SEG, configs, \
    jax_draws, make_batch, random_params

from td_vc_gan_tpu.models import CollaborativeMultibandDiscriminator as JaxD
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models.generator import Generator as JaxG
from td_vc_gan_tpu.training import state as jstate
from td_vc_gan_tpu.training import step as jstep
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models.crepe import Crepe
from td_vc_gan_tpu_torch.models.discriminator import CollaborativeMultibandDiscriminator
from td_vc_gan_tpu_torch.models.generator import Generator
from td_vc_gan_tpu_torch.training import state as tstate
from td_vc_gan_tpu_torch.training import step as tstep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stepped():
    jax_cfg, cfg = configs()
    jax_cfg.train.compute_dtype = "bfloat16"
    G = JaxG(decoder_ratios=RATIOS, decoder_channels=CHANNELS, num_bottleneck_layers=0,
             num_classes=NUM_SPK, conditional_dim=8, content_dim=8, **MRF)
    D = JaxD(num_disc=3, num_classes=NUM_SPK, num_channels_base=4)
    x = jnp.zeros((1, SEG, 1))
    pg = random_params(G, x, jnp.zeros((1, NUM_SPK)), None, x, seed=1)
    pd = random_params(D, x, jnp.zeros((1,), jnp.int32), D.get_subsamples(x, 3), seed=2)
    cp = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    st, opts = jstate.create_train_state(jax_cfg, pg, pd, None, cp)
    batch = make_batch()
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jstep.build_train_step(jax_cfg, G, D, None, opts))
    _, jmetrics = step(st, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    draws = jax_draws(rng, B, SEG // int(np.prod(RATIOS)))

    def port_step(compute_dtype):
        cfg.train.compute_dtype = compute_dtype
        tG = weights.generator_from_jax(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), pg)
        tD = weights.discriminator_from_jax(
            CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), pd)
        crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray, cp))
        state = tstate.create_train_state(cfg, tG, tD, None, crepe)
        metrics = tstep.build_train_step(cfg, state)(
            {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
        return {k: float(v) for k, v in metrics.items()}, state

    m16, state = port_step("bfloat16")
    m32, _ = port_step("float32")
    return dict(jmetrics={k: float(v) for k, v in jmetrics.items()}, metrics=m16, f32=m32,
                state=state)


def test_bf16_metrics_match_jax(stepped):
    jm, m, f = stepped["jmetrics"], stepped["metrics"], stepped["f32"]
    assert set(m) == set(jm) == set(f)
    assert all(np.isfinite(v) for v in m.values())
    scale = {k: max(abs(jm[k]), 1e-6) for k in jm}
    bf16_err = max(abs(jm[k] - f[k]) / max(abs(f[k]), 1e-6) for k in jm)
    assert bf16_err > 0  # the JAX step ran in bf16
    for k in sorted(jm):
        assert abs(m[k] - jm[k]) / scale[k] <= 2 * bf16_err + 1e-4, (k, m[k], jm[k], bf16_err)


def test_bf16_step_keeps_parameters_and_moments_f32(stepped):
    st = stepped["state"]
    assert st.step == 1
    for net, opt in ((st.G, st.opt_g), (st.D, st.opt_d)):
        for p in net.parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            moments = opt.optimizer.state[p]
            assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32
