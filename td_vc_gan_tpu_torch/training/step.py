"""The GAN train step: D update, C update, G update, in that order.

Counterpart of ``td_vc_gan_tpu/training/step.py`` (``compute_pitch_features``,
``build_train_step``, ``build_eval_step``), with the math of its defaults:

- G runs once per step: the source is encoded once and the conversion and
  identity passes are decoded from that content at batch 2B; the G loss
  differentiates through this same graph.
- D is updated on real and fake (fake detached); the G loss then sees the
  updated D in one batched D apply over its parts (adv, real, rec, idt) and
  gives D's parameters no gradient.
- The rec pass's content serves as the converted embedding of the
  contrastive loss.

The JAX step's XLA and TPU devices (weight-norm hoisting, remat, shard_map,
``lax.cond`` gating, the perf flags) are not carried over: they leave the math
unchanged. Randomness comes from a ``torch.Generator`` on the batch's device;
``draws`` injects any of it instead (see :func:`build_train_step`).
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F

from td_vc_gan_tpu_torch.models import crepe as crepe_mod
from td_vc_gan_tpu_torch.ops import dsp, losses
from td_vc_gan_tpu_torch.training.state import TrainState

HOP = 64


def compute_pitch_features(crepe, signal, perm, sample_rate: int, no_conv: bool,
                           draws: dict, generator=None) -> dict:
    """F0s, the pitch-shifted CREPE activation targets and the two
    excitations of a (B, T) batch: f0_src, f0_conv, act_conv_tgt, exc_conv
    and exc_src ((B, T, 1)). ``draws["exc_conv"]``/``draws["exc_src"]`` are
    (start_phase, noise) pairs."""
    with torch.no_grad():
        f0_src, act_src = crepe_mod.filtered_pitch(crepe, signal)
    if no_conv:
        f0_conv, act_conv_tgt = f0_src, act_src
    else:
        mu_tgt = crepe_mod.log_f0_mean(f0_src[perm])
        mu_src = crepe_mod.log_f0_mean(f0_src)
        f0_conv = torch.where(f0_src > 0,
                              torch.exp(torch.log(f0_src + 1e-6) + mu_tgt - mu_src), 0.0)
        shift = crepe_mod.get_shift(torch.exp(mu_src)[:, 0], torch.exp(mu_tgt)[:, 0])
        act_conv_tgt = dsp.roll_batches(act_src, shift, axis=2)

    def excitation(f0, name):
        start, noise = draws.get(name, (None, None))
        return dsp.f0_to_excitation(f0, HOP, sample_rate, start_phase=start, noise=noise,
                                    generator=generator)[..., None]

    return dict(f0_src=f0_src, f0_conv=f0_conv, act_conv_tgt=act_conv_tgt,
                exc_conv=excitation(f0_conv, "exc_conv"), exc_src=excitation(f0_src, "exc_src"))


def _on_device(draws: dict | None, device) -> dict:
    """The injected draws with every array as a tensor on ``device``
    (scalars stay Python numbers)."""

    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(u) for u in v)
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v,
                                   device=device)
        return v

    return {k: conv(v) for k, v in (draws or {}).items()}


def _zeroed(metrics: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in metrics.items()}


def _as_metrics(tree: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device).detach()
            for k, v in tree.items()}


def build_train_step(cfg, state: TrainState) -> Callable:
    """Returns ``train_step(batch, generator=None, draws=None) -> metrics``,
    which updates ``state`` in place (D, then C when used, then G) and
    returns the JAX step's metrics as 0-d tensors on the device.

    ``batch``: signal (B, T) float32, label (B,) int, corrupted (B, T)
    optional. ``draws`` may hold: ``perm`` (B,), ``exc_conv`` and ``exc_src``
    ((start_phase, noise (B, T))), ``jitter`` (B,) shifts, and
    ``neg_corrupted``/``neg_converted`` ((idx_x, idx_y), each (B, T', 100)
    draws from [0, T'-1)); the rest comes from ``generator``.
    """
    t = cfg.train
    G, D, C, crepe = state.G, state.D, state.C, state.crepe
    use_c = C is not None and (t.lambda_latcls != 0 or cfg.log.val_lat_cls)
    num_classes = G.num_classes
    num_disc = cfg.model.discriminator.num_disc
    sr = cfg.model.sample_rate
    fft_sizes = tuple(t.mel_fft_sizes)
    g_params = list(G.parameters())

    def train_step(batch: dict, generator: torch.Generator | None = None,
                   draws: dict | None = None) -> dict:
        signal = batch["signal"]
        dev = signal.device
        draws = _on_device(draws, dev)
        label_src = batch["label"].to(dev, torch.int64)
        x = signal[..., None]
        b = signal.shape[0]
        metrics = {}

        c_src = F.one_hot(label_src, num_classes).to(signal.dtype)
        if t.no_conv:
            perm = torch.arange(b, device=dev)
        elif "perm" in draws:
            perm = draws["perm"].to(torch.int64)
        else:
            perm = torch.randperm(b, generator=generator, device=dev)
        label_tgt = label_src[perm]
        c_tgt = F.one_hot(label_tgt, num_classes).to(signal.dtype)

        pf = compute_pitch_features(crepe, signal, perm, sr, t.no_conv, draws, generator)
        exc_conv, exc_src, act_conv_tgt = pf["exc_conv"], pf["exc_src"], pf["act_conv_tgt"]

        # ---- G once: encode the source once, decode conversion + identity at 2B
        batch_idt = (not t.no_conv) and t.lambda_idt > 0
        cont_enc = G(x, None, encode_only=True)
        if batch_idt:
            gout, gsubs, gcont = G(None, torch.cat([c_tgt, c_src]),
                                   torch.cat([exc_conv, exc_src]),
                                   content=torch.cat([cont_enc, cont_enc]))
        else:
            gout, gsubs, gcont = G(None, c_tgt, exc_conv, content=cont_enc)
        fake, subs, cont = gout[:b], [s[:b] for s in gsubs], gcont[:b]

        # ---- D update on real + fake (one batched apply) ----
        with torch.no_grad():
            real_subs = D.get_subsamples(x, num_disc)

        def d_loss():
            outs, _ = D(torch.cat([x, fake.detach()]), torch.cat([label_src, label_tgt]),
                        [torch.cat([r, f.detach()]) for r, f in zip(real_subs, subs)])
            l_real, l_fake, per_r, per_f = losses.lsgan_d_loss([o[:b] for o in outs],
                                                               [o[b:] for o in outs])
            aux = {"D_loss_adv_real": l_real, "D_loss_adv_fake": l_fake}
            for i, (r, f) in enumerate(zip(per_r, per_f)):
                aux[f"D_loss_adv_real_{i}"] = r
                aux[f"D_loss_adv_fake_{i}"] = f
            aux["D_loss"] = l_real + l_fake
            return aux

        if state.step % max(t.D_step_interval, 1) == 0:
            d_aux = d_loss()
            state.opt_d.zero_grad()
            d_aux["D_loss"].backward()
            state.opt_d.step()
            metrics.update(_as_metrics(d_aux, dev))
        else:
            with torch.no_grad():
                metrics.update(_zeroed(_as_metrics(d_loss(), dev)))

        # ---- latent-classifier update ----
        if use_c:
            if state.step % max(t.D_step_interval, 1) == 0:
                logits = C(cont.detach())
                c_loss = losses.cross_entropy_loss(logits, label_src)
                state.opt_c.zero_grad()
                c_loss.backward()
                state.opt_c.step()
                acc = torch.mean((torch.argmax(logits, -1) == label_src).to(torch.float32))
                metrics.update(_as_metrics({"C_loss": c_loss, "C_acc": acc}, dev))
            else:
                zero = torch.zeros((), device=dev)
                metrics.update({"C_loss": zero, "C_acc": zero})

        # ---- G loss against the updated D (and C) ----
        def g_loss():
            aux = {}
            use_rec = (not t.no_conv) and t.lambda_rec > 0
            use_idt = t.lambda_idt > 0
            real_j = x
            if (t.lambda_rec > 0 or t.lambda_idt > 0) and t.jitter_amp > 0:
                real_j = dsp.add_jitter(signal, t.jitter_amp, draws.get("jitter"),
                                        generator)[..., None]
            parts = [("adv", fake, label_tgt, subs)]
            if t.lambda_feat > 0 and (use_rec or use_idt):
                with torch.no_grad():
                    parts.append(("real", real_j, label_src,
                                  D.get_subsamples(real_j, num_disc)))
            rec = cont_rec = None
            if use_rec:
                rec, rec_subs, cont_rec = G(fake.detach(), c_src, exc_src)
                if t.lambda_feat > 0:
                    parts.append(("rec", rec, label_src, rec_subs))
            idt = None
            if use_idt and batch_idt:
                idt = gout[b:]
                if t.lambda_feat > 0:
                    parts.append(("idt", idt, label_src, [s[b:] for s in gsubs]))
            elif use_idt:  # no_conv: the identity pass is the conversion pass
                idt = fake

            outs_all, feats_all = D(torch.cat([p[1] for p in parts]),
                                    torch.cat([p[2] for p in parts]),
                                    [torch.cat(ss) for ss in zip(*(p[3] for p in parts))])
            index = {name: i for i, (name, *_) in enumerate(parts)}

            def part(maps, name):
                i = index[name]
                if isinstance(maps, torch.Tensor):
                    return maps[i * b:(i + 1) * b]
                return [part(m, name) for m in maps]

            g_adv, per_scale = losses.lsgan_g_loss(part(outs_all, "adv"))
            for i, v in enumerate(per_scale):
                aux[f"G_loss_adv_fake_{i}"] = v
            aux["G_loss_adv_fake"] = g_adv
            total = g_adv
            feats_real = part(feats_all, "real") if "real" in index else None

            def recon(sig, feats_name, prefix):
                loss = 0.0
                if t.lambda_feat > 0:
                    fl = losses.multiscale_feat_loss(part(feats_all, feats_name), feats_real)
                    aux[f"G_loss_{prefix}_feat"] = fl
                    loss += t.lambda_feat * fl
                if t.lambda_spec > 0:
                    sl = losses.multiscale_spec_loss(sig[..., 0], real_j[..., 0], fft_sizes, sr)
                    aux[f"G_loss_{prefix}_spec"] = sl
                    loss += t.lambda_spec * sl
                if t.lambda_wave > 0:
                    wl = losses.wave_l1_loss(sig[..., 0], signal)
                    aux[f"G_loss_{prefix}_wave"] = wl
                    loss += t.lambda_wave * wl
                return loss

            g_rec = recon(rec, "rec", "rec") if use_rec else 0.0
            aux["G_loss_rec"] = g_rec
            total = total + t.lambda_rec * g_rec
            g_idt = recon(idt, "idt" if "idt" in index else "adv", "idt") if use_idt else 0.0
            aux["G_loss_idt"] = g_idt
            total = total + t.lambda_idt * g_idt

            g_cont = 0.0
            if t.lambda_cont_emb > 0:
                corrupted = t.lambda_corrupted and "corrupted" in batch
                reuse = cont_rec is not None
                enc_in = []
                if corrupted:
                    enc_in.append(batch["corrupted"][..., None])
                if t.lambda_converted and not reuse:
                    enc_in.append(fake.detach())
                embs = G(torch.cat(enc_in), None, encode_only=True) if enc_in else None
                i_enc = 0
                if corrupted:
                    i_enc = 1
                    g_cont = g_cont + t.lambda_corrupted * losses.contrastive_loss(
                        cont, embs[:b], 100, 0.1, draws.get("neg_corrupted"), generator)
                if t.lambda_converted:
                    emb_conv = cont_rec if reuse else embs[i_enc * b:(i_enc + 1) * b]
                    g_cont = g_cont + t.lambda_converted * losses.contrastive_loss(
                        cont, emb_conv, 100, 0.1, draws.get("neg_converted"), generator)
            aux["G_loss_cont_emb"] = g_cont
            total = total + t.lambda_cont_emb * g_cont

            g_lat = 0.0
            if use_c and t.lambda_latcls != 0:
                g_lat = losses.cross_entropy_loss(C(cont), label_src)
            aux["G_loss_lat_cls"] = g_lat
            total = total + t.lambda_latcls * g_lat

            g_f0 = 0.0
            if t.lambda_f0 != 0:
                _, act_conv = crepe_mod.filtered_pitch(crepe, fake[..., 0])
                g_f0 = torch.mean((act_conv - act_conv_tgt.detach()) ** 2)
            aux["g_loss_f0"] = g_f0
            total = total + t.lambda_f0 * g_f0
            aux["G_loss"] = total
            return aux

        if state.step % max(t.G_step_interval, 1) == 0:
            g_aux = g_loss()
            state.opt_g.zero_grad()
            # only G's parameters: D's and C's take nothing from the G loss
            g_aux["G_loss"].backward(inputs=g_params)
            state.opt_g.step()
            metrics.update(_as_metrics(g_aux, dev))
        else:
            with torch.no_grad():
                metrics.update(_zeroed(_as_metrics(g_loss(), dev)))
        state.step += 1
        return metrics

    return train_step


def build_eval_step(cfg, state: TrainState) -> Callable:
    """Returns ``eval_step(batch, generator=None, draws=None) -> metrics``:
    the LSGAN numbers on real and fake, and the latent classifier's loss and
    accuracy when there is one. ``draws`` may hold ``label_tgt`` (B,) and
    ``exc`` (start_phase, noise)."""
    t = cfg.train
    G, D, C, crepe = state.G, state.D, state.C, state.crepe
    num_classes = G.num_classes
    sr = cfg.model.sample_rate

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator | None = None,
                  draws: dict | None = None) -> dict:
        signal = batch["signal"]
        dev = signal.device
        draws = _on_device(draws, dev)
        label_src = batch["label"].to(dev, torch.int64)
        x = signal[..., None]
        if t.no_conv:
            label_tgt = label_src
        elif "label_tgt" in draws:
            label_tgt = draws["label_tgt"].to(torch.int64)
        else:
            label_tgt = torch.randint(0, num_classes, label_src.shape, generator=generator,
                                      device=dev)
        c_tgt = F.one_hot(label_tgt, num_classes).to(signal.dtype)
        f0_src, _ = crepe_mod.filtered_pitch(crepe, signal)
        start, noise = draws.get("exc", (None, None))
        exc = dsp.f0_to_excitation(f0_src, HOP, sr, start_phase=start, noise=noise,
                                   generator=generator)[..., None]
        fake, _, cont = G(x, c_tgt, exc)
        out_real, _ = D(x, label_src, ())
        out_fake, _ = D(fake, label_tgt, ())
        l_real, l_fake, _, _ = losses.lsgan_d_loss(out_real, out_fake)
        g_adv, _ = losses.lsgan_g_loss(out_fake)
        m = {"val_loss_adv_real": l_real, "val_loss_adv_fake": l_fake,
             "val_D_loss": l_real + l_fake, "val_G_loss": g_adv}
        if C is not None:
            logits = C(cont)
            m["val_loss_lat_cls"] = losses.cross_entropy_loss(logits, label_src)
            m["val_C_acc"] = torch.mean((torch.argmax(logits, -1) == label_src).float())
        return _as_metrics(m, dev)

    return eval_step
