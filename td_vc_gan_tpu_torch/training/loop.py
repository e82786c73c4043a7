"""Training loop: epochs over the host input pipeline around the train step.

Counterpart of ``td_vc_gan_tpu/training/loop.py`` (the reference's train.py
main loop, train.py:77-651) for one process and one device: it logs scalars
(to TensorBoard when ``tensorboardX`` is installed), runs validation, saves
the full train state and the reference-format ``.pt`` files, and dumps sample
conversions, each at its interval, with the JAX loop's semantics:

- epochs ``range(start_epoch, num_epoch + 1)``, ``len(train) // batch``
  steps each; the step counter starts at ``start_epoch * steps_per_epoch``
  and ``max_steps`` is compared against it;
- resume from ``load_path``: the port's full train state first (the newest,
  or ``epoch``), else the reference's ``step{epoch}-*.pt`` / ``latest-*.pt``
  merged with :func:`checkpoint.load_possible`;
- the random stream restarts from ``train.seed`` in every call;
- ``wavlm_checkpoint`` (a Microsoft WavLM ``.pt``) sizes and fills the frozen
  backbone of a WavLM-encoder config; without it the backbone comes from the
  seed. The loop logs the backbone's digest (:func:`wavlm.wavlm_digest`)
  after loading it, after a resume and at the end.

In a process group of W ranks (``parallel.initialize_multihost``, one
process per GPU), every rank runs this loop in lockstep, as every host runs
the JAX loop: rank r serves its 1/W slice of the train manifest with the
seed ``train.seed + r`` and a local batch of ``batch_size // W``, and the
train step averages across ranks; validation runs the same batches on every
rank. Only rank 0 writes (provenance, TensorBoard, saves, the reference
``.pt`` export, samples, the step lines); every rank meets it at a barrier
after its saves and samples. Every rank resumes from the same files, and
the loop checks that all ranks start from the same train state. Rank 0
builds the kernel libraries before the others load them. The device mesh,
jit caches and the JAX compilation cache have no counterpart here.

The host side (decoding, augmentation, corruption) runs in the data
pipeline's worker processes, forked from a fork server that starts as a new
process (no CUDA or NCCL state); batches go to the device through pinned
memory.

Each logged step line carries, besides the metrics, the step's wall time
(``step_ms``, which ends in the metrics' copy to the host), the time the
loop waited on the input pipeline (``data_wait_ms``) and the cond-chain
kernel launches of that step (``k1``/``k2``, 0 on the CPU), f32 and bf16
instances together; the final line counts the bf16 ones apart. As in the JAX
loop, the sample dumps run G outside the compute scope (f32 convs).
"""

from __future__ import annotations

import dataclasses
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from td_vc_gan_tpu_torch import parallel, resolve_device
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.data.audio_io import write_audio
from td_vc_gan_tpu_torch.data.dataset import WaveDataset, make_train_iterator
from td_vc_gan_tpu_torch.models import crepe as crepe_mod
from td_vc_gan_tpu_torch.models.discriminator import discriminator_from_config
from td_vc_gan_tpu_torch.models.generator import generator_from_config
from td_vc_gan_tpu_torch.models.latent_classifier import LatentClassifier
from td_vc_gan_tpu_torch.models.layers import init_weights
from td_vc_gan_tpu_torch.models.wavlm import load_wavlm_checkpoint, wavlm_digest
from td_vc_gan_tpu_torch.ops import dsp
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cc_mod
from td_vc_gan_tpu_torch.training import checkpoint as ckpt
from td_vc_gan_tpu_torch.training import state as state_mod
from td_vc_gan_tpu_torch.training import step as step_mod


def build_models(cfg: Config, num_spk: int, device=None, seed: int | None = None,
                 wavlm_cfg=None):
    """G, D and (when the config uses it) the latent classifier C, with
    weights made from ``seed`` (default ``train.seed``; D and C from the next
    seeds), on ``device``; ``wavlm_cfg`` sizes a WavLM encoder's backbone
    (None: WavLM-Large in ``train.compute_dtype``). The port's modules hold
    their weights, so this is also the JAX loop's ``init_params``; CREPE
    comes from :func:`build_crepe`."""
    seed = cfg.train.seed if seed is None else seed
    dev = resolve_device(device)
    G = generator_from_config(cfg.model.generator, num_spk, dev, seed, wavlm_cfg=wavlm_cfg,
                              compute_dtype=cfg.train.compute_dtype)
    D = discriminator_from_config(cfg, num_spk, dev, seed + 1)
    C = None
    if cfg.train.lambda_latcls != 0 or cfg.log.val_lat_cls:
        C = init_weights(LatentClassifier(cfg.model.generator.content_dim, num_spk),
                         seed + 2).to(dev)
    return G, D, C


def build_crepe(cfg: Config, crepe_weights: str | None = None, device=None):
    """The frozen pitch net: torchcrepe weights when given, else seeded."""
    if crepe_weights:
        from td_vc_gan_tpu_torch.training.torch_import import load_torchcrepe

        net = load_torchcrepe(crepe_weights)
    else:
        net = crepe_mod.crepe_from_seed(cfg.train.seed + 3)
    return net.to(resolve_device(device))


def _write_provenance(cfg: Config, save_path: Path, config_file: str | None):
    """The run directory's provenance files, as the JAX loop writes them:
    the effective config (``config.yaml``), the original config file
    (``config.orig.yaml``), the git hash and the command line."""
    save_path.mkdir(parents=True, exist_ok=True)
    (save_path / "generated").mkdir(exist_ok=True)
    cfg.save(save_path / "config.yaml")
    if config_file:
        import shutil

        try:
            shutil.copy2(config_file, save_path / "config.orig.yaml")
        except shutil.SameFileError:
            pass
    try:
        h = subprocess.check_output(["git", "rev-parse", "--short", "HEAD"],
                                    stderr=subprocess.DEVNULL).strip().decode()
        (save_path / "githash").write_text(h)
    except (OSError, subprocess.CalledProcessError):
        pass
    (save_path / "argv").write_text(" ".join(sys.argv))


def state_digest(state: state_mod.TrainState) -> str:
    """SHA-256 of every weight, optimizer moment and step count of the
    state, in a fixed order: equal digests mean a bit-identical state."""
    h = hashlib.sha256()
    nets = [("G", state.G, state.opt_g), ("D", state.D, state.opt_d)]
    if state.C is not None:
        nets.append(("C", state.C, state.opt_c))
    for tag, net, opt in nets:
        for name, t in net.state_dict().items():
            h.update(f"{tag}.{name}".encode())
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        for i, p in enumerate(opt.params):
            for key, t in sorted(opt.optimizer.state.get(p, {}).items()):
                h.update(f"{tag}.opt{i}.{key}".encode())
                h.update(torch.as_tensor(t).detach().cpu().contiguous().numpy().tobytes())
    h.update(str(state.step).encode())
    return h.hexdigest()


def backbone_note(G) -> str:
    """', backbone digest ...' for a WavLM-encoder G, else ''."""
    wavlm = ckpt.backbone(G)
    return "" if wavlm is None else f", backbone digest {wavlm_digest(wavlm)}"


def _to_device(batch: dict, dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def _launches() -> tuple[int, int]:
    """(K1, K2) launches so far, f32 and bf16 instances together."""
    f32, bf16 = cc_mod.kernel_launches("float32"), cc_mod.kernel_launches("bfloat16")
    return f32[0] + bf16[0], f32[1] + bf16[1]


def train(
    cfg: Config,
    save_path: str | Path,
    data_path: str | Path,
    load_path: str | Path | None = None,
    epoch: str | int | None = None,
    config_file: str | None = None,
    max_steps: int | None = None,
    crepe_weights: str | None = None,
    profile_dir: str | None = None,
    precorrupted_index: str | None = None,
    wavlm_checkpoint: str | None = None,
    device=None,
    log_fn=print,
) -> state_mod.TrainState:
    """Run the training loop on ``device`` (default: the CUDA card; a
    machine without one raises), as one rank of the process group when one
    was joined. Returns the final TrainState. A resume from a saved train
    state runs in the state's ``train.compute_dtype``."""
    dev = resolve_device(device)
    rank, world = parallel.rank_world()
    group = None if world == 1 else torch.distributed.group.WORLD
    is_main = rank == 0
    batch_size = parallel.local_batch(cfg.train.batch_size, world)
    log_main = log_fn if is_main else (lambda *_: None)
    who = "" if world == 1 else f"[rank {rank}/{world}] "
    save_path, data_path = Path(save_path), Path(data_path)
    state_epoch = None
    if load_path is not None:
        load_path = Path(load_path)
        state_epoch = ckpt.latest_epoch(load_path) if epoch is None else (
            int(epoch) if ckpt.has_state(load_path, int(epoch)) else None)
    if state_epoch is not None:
        saved = ckpt.load_state_file(load_path, state_epoch).get("compute_dtype")
        if saved is not None and saved != cfg.train.compute_dtype:
            log_main(f"train.compute_dtype {saved} from the train state of epoch "
                     f"{state_epoch} (the config said {cfg.train.compute_dtype})")
            cfg.train.compute_dtype = saved
    writer = None
    if is_main:
        _write_provenance(cfg, save_path, config_file)
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(str(save_path / "logs"))
        except ImportError:
            pass

    train_ds = WaveDataset(
        data_path / "train_files", data_path / "speakers",
        sample_rate=cfg.model.sample_rate, max_segment_size=cfg.train.max_segment,
        augment_noise=1e-9, normalization_db=cfg.train.normalization_db,
        data_augment=True, corrupt=True, pad_to_max=True, seed=cfg.train.seed,
        precorrupted_index=precorrupted_index,
    )
    test_ds = WaveDataset(
        data_path / "test_files", data_path / "speakers",
        sample_rate=cfg.model.sample_rate, max_segment_size=cfg.test.max_segment,
        normalization_db=cfg.train.normalization_db, seed=cfg.train.seed,
    )
    if world > 1:
        # equal slices keep every rank's step count the same
        per = len(train_ds.entries) // world
        train_ds.entries = train_ds.entries[rank * per:(rank + 1) * per]
        log_fn(f"[host {rank}/{world}] serving {per} of the manifest, local batch {batch_size}")
        if dev.type == "cuda":
            if is_main:
                cc_mod.build()
            parallel.barrier(dev, group)

    wavlm_cfg = wavlm_state = None
    if wavlm_checkpoint and cfg.model.generator.encoder_model == "wavlm":
        wavlm_cfg, wavlm_state = load_wavlm_checkpoint(wavlm_checkpoint)
        # the file's config has no compute_dtype: the backbone takes the run's
        if cfg.train.compute_dtype != "float32":
            wavlm_cfg = dataclasses.replace(wavlm_cfg, compute_dtype=cfg.train.compute_dtype)
    G, D, C = build_models(cfg, train_ds.num_spk, dev, wavlm_cfg=wavlm_cfg)
    if wavlm_state is not None:
        ckpt.backbone(G).load_state_dict(wavlm_state)
        log_main(f"Loaded WavLM backbone from {wavlm_checkpoint} ({len(wavlm_state)} tensors, "
                 f"{sum(t.numel() for t in wavlm_state.values())} parameters"
                 f"{backbone_note(G)})")
        del wavlm_state
    crepe = build_crepe(cfg, crepe_weights, dev)
    state = state_mod.create_train_state(cfg, G, D, C, crepe)

    # resume (reference semantics: --load_path [+ --epoch], train.py:156-181)
    start_epoch = 0
    if load_path is not None:
        if state_epoch is not None:
            restored = ckpt.restore_state(state, load_path, state_epoch)
            start_epoch = state_epoch + 1
            seeded = ", C from the seed" if C is not None and "C" not in restored else ""
            log_fn(f"{who}Resumed train state epoch {state_epoch} (step {state.step}, "
                   f"digest {state_digest(state)}{backbone_note(G)}; restored "
                   f"{'+'.join(restored)}{seeded})")
        else:
            base = f"step{epoch}" if epoch is not None else "latest"
            g_file = load_path / f"{base}-G.pt"
            if g_file.exists():
                msg = ckpt.import_torch_generator(cfg, g_file, G)
                log_main(f"Loaded {g_file}: {len(msg['matched'])} matched")
                d_file = load_path / f"{base}-D.pt"
                if d_file.exists():
                    ckpt.import_torch_discriminator(cfg, d_file, D)
                c_file = load_path / f"{base}-C.pt"
                if C is not None and c_file.exists():
                    ckpt.import_torch_classifier(c_file, C)
                if epoch is not None:
                    start_epoch = int(epoch) + 1

    if world > 1:
        digest = state_digest(state)
        parallel.check_replicas(digest, dev, group)
        log_main(f"{world} ranks start from the same train state (digest {digest})")

    train_step = step_mod.build_train_step(cfg, state, group)
    eval_step = step_mod.build_eval_step(cfg, state)
    it = make_train_iterator(train_ds, batch_size, num_workers=int(cfg.train.num_workers),
                             seed=cfg.train.seed + rank)
    steps_per_epoch = len(train_ds) // batch_size
    rng = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    iter_count = start_epoch * steps_per_epoch
    t0 = time.time()
    samples_done = 0
    k_start = _launches()
    bf16_start = cc_mod.kernel_launches("bfloat16")
    k_val = k_gen = 0
    prof = None
    try:
        for ep in range(start_epoch, cfg.train.num_epoch + 1):
            for _ in range(steps_per_epoch):
                t_wait = time.perf_counter()
                _, batch = next(it)
                t_step = time.perf_counter()
                batch = _to_device(batch, dev)
                if profile_dir and iter_count == 10 and is_main:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                     if dev.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
                k0 = _launches()
                metrics = train_step(batch, rng)
                k1 = _launches()
                if prof is not None and iter_count == 15:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    prof.__exit__(None, None, None)
                    Path(profile_dir).mkdir(parents=True, exist_ok=True)
                    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
                    prof = None
                    log_fn(f"profiler trace written to {profile_dir}")
                samples_done += world * batch["signal"].shape[0] * batch["signal"].shape[1]

                if iter_count % cfg.log.log_interval == 0 and is_main:
                    values = {k: float(v) for k, v in sorted(metrics.items())}  # syncs
                    line = f"Epoch {ep}/{cfg.train.num_epoch}, Itt {iter_count}"
                    for k, v in values.items():
                        if writer:
                            writer.add_scalar(k, v, iter_count)
                        line += f", {k}: {v:.4f}"
                    rate = samples_done / max(time.time() - t0, 1e-9)
                    line += (f", wav_samples/s: {rate:.0f}, step_ms: "
                             f"{(time.perf_counter() - t_step) * 1e3:.2f}, data_wait_ms: "
                             f"{(t_step - t_wait) * 1e3:.2f}, k1: {k1[0] - k0[0]}, "
                             f"k2: {k1[1] - k0[1]}")
                    log_fn(line)
                iter_count += 1
                if max_steps is not None and iter_count >= max_steps:
                    break

            if max_steps is not None and iter_count >= max_steps:
                break

            if ep % cfg.log.val_interval == 0 and len(test_ds):
                k0 = _launches()
                vals: dict = {}
                n_val = min(len(test_ds), cfg.test.num_tests)
                for i in range(n_val):
                    item = test_ds.__getitem__(i)
                    sig = _pad_bucket(item["signal"], cfg.test.max_segment)
                    vb = {"signal": torch.from_numpy(sig[None]).to(dev),
                          "label": torch.from_numpy(item["label"][None]).to(dev)}
                    for key, v in eval_step(vb, rng).items():
                        vals[key] = vals.get(key, 0.0) + float(v)
                line = f"Val Epoch {ep}/{cfg.train.num_epoch}"
                for k, v in sorted(vals.items()):
                    if writer:
                        writer.add_scalar(k, v / n_val, iter_count)
                    line += f", {k}: {v / n_val:.4f}"
                k_val += _launches()[0] - k0[0]
                log_main(line + f", k1: {_launches()[0] - k0[0]}")

            save = ep % cfg.log.save_interval == 0
            samples = ep % cfg.log.gen_interval == 0 and len(test_ds)
            if save and is_main:
                log_fn("Saving checkpoint")
                t_save = time.perf_counter()
                path = ckpt.save_state(state, save_path, ep, cfg.train.compute_dtype)
                ckpt.export_torch(state, cfg, save_path, ep)
                nbytes = path.stat().st_size + sum(
                    (save_path / f"step{ep}-{tag}.pt").stat().st_size
                    for tag in ("G", "D", "C") if (save_path / f"step{ep}-{tag}.pt").exists())
                log_fn(f"Saved epoch {ep} in {time.perf_counter() - t_save:.3f} s, "
                       f"{nbytes} bytes (train state and step{ep}-*.pt), "
                       f"digest {state_digest(state)}")

            if samples and is_main:
                k0 = _launches()
                # rank 0 alone draws for the samples: from a copy of the
                # stream under a group, which the other ranks share
                _generate_samples(cfg, state, test_ds, save_path, ep,
                                  rng if world == 1 else _copy(rng), log_fn)
                k_gen += _launches()[0] - k0[0]
            if world > 1 and (save or samples):
                parallel.barrier(dev, group)
    finally:
        it.close()
        if prof is not None:
            prof.__exit__(None, None, None)

    k_end = _launches()
    bf16_end = cc_mod.kernel_launches("bfloat16")
    peak = (f", peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "")
    log_fn(f"{who}Done at step {iter_count}: cond-chain launches K1 {k_end[0] - k_start[0]} "
           f"(validation {k_val}, samples {k_gen}), K2 {k_end[1] - k_start[1]} (bf16 "
           f"instances: K1 {bf16_end[0] - bf16_start[0]}, K2 {bf16_end[1] - bf16_start[1]})"
           f"{peak}{backbone_note(state.G)}")
    if writer:
        writer.close()
    return state


def _copy(rng: torch.Generator) -> torch.Generator:
    """A generator at ``rng``'s state, which draws without moving ``rng``."""
    out = torch.Generator(device=rng.device)
    out.set_state(rng.get_state())
    return out


def _pad_bucket(signal: np.ndarray, cap: int, quantum: int = 8960) -> np.ndarray:
    """Zero-pad an utterance to a shape bucket (multiples of ``quantum``,
    capped), as the JAX loop does for validation and samples."""
    n = min(len(signal), cap)
    target = min(-(-n // quantum) * quantum, -(-cap // quantum) * quantum)
    out = np.zeros(target, signal.dtype)
    out[:n] = signal[:n]
    return out


@torch.no_grad()
def _sample(cfg, state, signal, label_tgt: int, label_src: int, ratio: float, rng):
    """One sample dump: pitch, excitation at ``ratio`` times the source F0,
    the conversion to ``label_tgt`` and its reconstruction back to
    ``label_src``. (1, T) -> (fake (1, T), rec (1, T))."""
    n = state.G.num_classes
    f0, _ = crepe_mod.filtered_pitch(state.crepe, signal)
    exc = dsp.f0_to_excitation(f0 * ratio, 64, cfg.model.sample_rate, generator=rng)[..., None]
    dev = signal.device
    onehot_t = F.one_hot(torch.tensor([label_tgt], device=dev), n).to(torch.float32)
    onehot_s = F.one_hot(torch.tensor([label_src], device=dev), n).to(torch.float32)
    fake, _, _ = state.G(signal[..., None], onehot_t, exc)
    rec, _, _ = state.G(fake, onehot_s, exc)
    return fake[..., 0], rec[..., 0]


def _generate_samples(cfg, state, test_ds, save_path: Path, ep: int, rng, log_fn):
    """Qualitative wav dumps with random pitch ratios (train.py:610-647), with
    the JAX loop's ratios, targets and file names."""
    log_fn("Saving signals")
    t0 = time.perf_counter()
    num = min(cfg.log.gen_num, len(test_ds))
    ratios = np.random.default_rng(ep).uniform(0.5, 2.0, size=num)
    ratios[0] = 1.0
    if cfg.train.no_conv:
        ratios[:] = 1.0
    dev = next(state.G.parameters()).device
    peaks = []
    for i in range(num):
        item = test_ds.__getitem__(i)
        signal = _pad_bucket(item["signal"], cfg.test.max_segment)[None]
        label_src = int(item["label"])
        label_tgt = (
            label_src
            if cfg.train.no_conv or i == 0
            else int(np.random.default_rng(ep * 100 + i).integers(test_ds.num_spk))
        )
        fake, rec = _sample(cfg, state, torch.from_numpy(signal).to(dev), label_tgt,
                            label_src, float(ratios[i]), rng)
        fake, rec = fake.cpu().numpy(), rec.cpu().numpy()
        ok = bool(np.isfinite(fake).all() and np.isfinite(rec).all())
        peaks.append(f"{max(np.abs(fake).max(), np.abs(rec).max()):.4f}"
                     + ("" if ok else " (not finite)"))
        base = f"epoch{ep:03d}_sig{i:02d}_{label_src:1d}-{label_tgt:1d}"
        gen = save_path / "generated"
        write_audio(gen / f"{base}_conv_r={ratios[i]:.2f}.wav", fake[0], cfg.model.sample_rate)
        write_audio(gen / f"{base}_orig.wav", signal[0], cfg.model.sample_rate)
        write_audio(gen / f"{base}_rec.wav", rec[0], cfg.model.sample_rate)
    dt = time.perf_counter() - t0
    log_fn(f"Saved {num} samples in {dt:.1f}s ({dt / max(num, 1):.2f}s/sample); "
           f"max|y| before writing: {', '.join(peaks)}")
