"""Manifest-driven waveform datasets and the prefetching train iterator.

The port's own copy of ``td_vc_gan_tpu/data/dataset.py``: the same
per-(index, epoch) seeding, crops, corruption, ``precorrupted_index`` replay,
file cache and prefetch, so that both packages make the same batches from
the same manifest and seed; the items are made in worker processes where
the JAX package uses threads. The batches stay numpy on the host;
the training loop moves them to the device.

Replaces the torch Dataset/DataLoader stack (data/dataset.py:22-211,
train.py:114-125) with a host pipeline designed for XLA:

- **Static shapes**: every train item is cropped/padded to exactly
  ``max_segment`` samples (the reference pads per-batch to the batch max,
  dataset.py:136-141,185-187 — zero-tail padding to the fixed maximum is
  behavior-compatible and kills recompilation).
- **Worker processes**: a pool of processes decodes/corrupts items while
  the device computes. The corruption's pitch marks, PSOLA walk and grain
  overlap-add are Python-level loops that hold the interpreter lock; in
  threads they stall the host-bound train step that launches the device's
  work, so they run in processes of their own. They are forked from a
  fork server that has imported this module (so not from the parent, which
  holds CUDA and threads, and without importing torch once per worker).
  Each worker gets the dataset once; items are seeded by (seed, epoch,
  index), so the batches do not depend on which worker made them.
- **Deterministic RNG**: one ``np.random.Generator`` per epoch per item
  index, derived from (seed, epoch, index).

Manifest format matches the reference: ``path|speaker`` lines plus a pickled
``speakers`` dict (scripts/prepare_dataset.py).
"""

from __future__ import annotations

import pickle
import queue
import threading
from pathlib import Path

import numpy as np

from td_vc_gan_tpu_torch.data import corruption
from td_vc_gan_tpu_torch.data.audio_io import read_audio, read_wav_slice, wav_meta
from td_vc_gan_tpu_torch.ops.dsp import eq_rms_gain


def load_speakers(path: str | Path) -> dict[str, int]:
    p = Path(path)
    if p.suffix == ".json":
        import json

        return json.loads(p.read_text())
    with open(p, "rb") as f:
        return pickle.load(f)


class WaveDataset:
    """Random-access dataset over a ``path|speaker`` manifest.

    Per-item processing mirrors data/dataset.py:89-150: load, RMS-normalize
    to ``normalization_db``, train-time random gain U(0.3, 1) + polarity,
    random non-silent crop to ``max_segment_size``, pad to
    ``min_segment_size`` (5120) and to a multiple of ``segment_multi`` (320),
    optional +1e-9 noise, optional corruption branch.
    """

    MIN_SEGMENT = 10 * 8 * 2 * 2 * 16  # 5120 (dataset.py:40)
    SEGMENT_MULTI = 10 * 8 * 2 * 2  # 320 (dataset.py:41)

    def __init__(
        self,
        dataset_file: str | Path,
        speaker_file: str | Path,
        sample_rate: int = 16000,
        max_segment_size: int | None = None,
        augment_noise: float | None = None,
        normalization_db: float | None = None,
        data_augment: bool = False,
        add_new_spks: bool = False,
        corrupt: bool = False,
        pad_to_max: bool = False,
        seed: int = 1234,
        precorrupted_index: str | Path | None = None,
    ):
        self.spk_dict = dict(load_speakers(speaker_file))
        with open(dataset_file) as f:
            self.entries = [line.strip().split("|") for line in f if line.strip()]
        if add_new_spks:
            for _, label in self.entries:
                if label not in self.spk_dict:
                    self.spk_dict[label] = len(self.spk_dict)
        self.spk_reverse_dict = {v: k for k, v in self.spk_dict.items()}
        self.num_spk = len(self.spk_dict)

        self.sr = sample_rate
        self.max_segment_size = max_segment_size
        self.augment_noise = augment_noise
        self.normalization_db = normalization_db
        self.data_augment = data_augment
        self.corrupt = corrupt
        self.pad_to_max = pad_to_max and max_segment_size is not None
        self.seed = seed
        # Offline corruption variants (cli/precorrupt_dataset.py): the host
        # corruption is the input-pipeline bottleneck for multi-chip DP
        # (bench input_feed_margin < 1 on few-core hosts); with an index the
        # corrupted branch becomes a read + the same gain/flip/crop replay.
        self.precorrupted: dict[str, list[str]] | None = None
        if precorrupted_index is not None:
            with open(precorrupted_index, "rb") as f:
                self.precorrupted = pickle.load(f)
        # Per-file cache: path -> (WavMeta | None, normalization gain | None).
        # Filled on first (full-decode) touch; afterwards the crop path reads
        # only the needed frames via read_wav_slice. Shared across the loader
        # thread pool — dict get/set is GIL-atomic, and a rare duplicate
        # first-touch compute is harmless.
        self._file_cache: dict[str, tuple] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def get_filename(self, index: int) -> str:
        return self.entries[index][0]

    def get_label(self, index: int):
        label = self.entries[index][1]
        return label, self.spk_dict[label]

    def _file_facts(self, path: str) -> tuple:
        """(WavMeta | None, norm gain | None) for ``path``, cached.

        A None WavMeta means slice reads are unavailable (non-wav, sample
        rate mismatch needing resample, or exotic encoding) and callers must
        take the full-decode path. The normalization gain is computed lazily
        by the first full decode (see _load_signal_meta)."""
        cached = self._file_cache.get(path)
        if cached is None:
            m = wav_meta(path) if path.lower().endswith(".wav") else None
            if m is not None and m.sr != self.sr:
                m = None  # resample path needs the whole signal
            cached = (m, None)
            self._file_cache[path] = cached
        return cached

    def _finalize(self, signal: np.ndarray, meta: dict,
                  rng: np.random.Generator) -> tuple[np.ndarray, dict]:
        """Shared tail of both load paths: pads + optional noise."""
        if signal.shape[0] < self.MIN_SEGMENT:
            signal = np.pad(signal, (0, self.MIN_SEGMENT - signal.shape[0]))
        if signal.shape[0] % self.SEGMENT_MULTI:
            pad = -(-signal.shape[0] // self.SEGMENT_MULTI) * self.SEGMENT_MULTI - signal.shape[0]
            signal = np.pad(signal, (0, pad))
        if self.pad_to_max and signal.shape[0] < self.max_segment_size:
            signal = np.pad(signal, (0, self.max_segment_size - signal.shape[0]))
        if self.augment_noise is not None:
            signal = signal + rng.standard_normal(signal.shape) * self.augment_noise
        meta["final_len"] = int(signal.shape[0])
        return signal.astype(np.float32), meta

    def _load_signal_meta(
        self, index: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, dict]:
        """Load + augment one signal; ``meta`` records the random transform
        so the precorrupted branch can replay it sample-aligned. The rng
        draw order is identical to the original load_signal.

        Fast path: once a file's header + normalization gain are cached and
        the item will be cropped anyway, read ONLY the crop slice
        (read_wav_slice) and apply the scalar normalize/gain/flip to it —
        bit-identical to transforming the full utterance first, because
        elementwise scalar ops commute with slicing. This is what makes the
        host pipeline able to feed multi-chip DP (bench
        ``input_feed_margin_8chip_dp``); the reference decodes whole files
        per item (data/dataset.py:89-150)."""
        meta: dict = {"gain": None, "flip": False, "crop": None}
        path, _ = self.entries[index]
        wmeta, norm_gain = self._file_facts(path)
        crop_len = self.max_segment_size
        if (wmeta is not None and crop_len and wmeta.n_frames > crop_len
                and (norm_gain is not None or not self.normalization_db)):
            if self.data_augment:
                meta["gain"] = rng.uniform(0.3, 1.0)
                if rng.integers(2):
                    meta["flip"] = True
            # random crop, rejecting all-zero crops (dataset.py:128-135) —
            # same rng draws as the full-decode path below
            for _ in range(16):
                idx = rng.integers(wmeta.n_frames - crop_len)
                crop = read_wav_slice(path, wmeta, int(idx), int(idx) + crop_len)
                if norm_gain is not None:
                    crop = crop * norm_gain
                if meta["gain"] is not None:
                    crop = crop * meta["gain"]
                if meta["flip"]:
                    crop = -crop
                if np.abs(crop).max() > 0:
                    break
            meta["crop"] = int(idx)
            return self._finalize(crop, meta, rng)

        signal, _ = read_audio(path, self.sr)
        if self.normalization_db:
            if norm_gain is None:
                norm_gain = eq_rms_gain(signal, self.normalization_db)
                self._file_cache[path] = (wmeta, norm_gain)
            signal = signal * norm_gain
        if self.data_augment:
            meta["gain"] = rng.uniform(0.3, 1.0)
            signal = signal * meta["gain"]
            if rng.integers(2):
                meta["flip"] = True
                signal = -signal
        if self.max_segment_size and signal.shape[0] > self.max_segment_size:
            # random crop, rejecting all-zero crops (dataset.py:128-135)
            for _ in range(16):
                idx = rng.integers(signal.shape[0] - self.max_segment_size)
                crop = signal[idx : idx + self.max_segment_size]
                if np.abs(crop).max() > 0:
                    break
            meta["crop"] = int(idx)
            signal = crop
        return self._finalize(signal, meta, rng)

    def load_signal(self, index: int, rng: np.random.Generator) -> np.ndarray:
        return self._load_signal_meta(index, rng)[0]

    def _replay_transform(self, wav: np.ndarray, meta: dict) -> np.ndarray:
        """Apply a recorded gain/flip/crop/pad transform to another render of
        the same utterance (the stored corrupted variant)."""
        if meta["gain"] is not None:
            wav = wav * meta["gain"]
        if meta["flip"]:
            wav = -wav
        if meta["crop"] is not None and self.max_segment_size:
            wav = wav[meta["crop"]: meta["crop"] + self.max_segment_size]
        n = meta["final_len"]
        if wav.shape[0] < n:
            wav = np.pad(wav, (0, n - wav.shape[0]))
        return wav[:n].astype(np.float32)

    def __getitem__(self, index: int, epoch: int = 0) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index])
        )
        signal, meta = self._load_signal_meta(index, rng)
        label = self.spk_dict[self.entries[index][1]]
        item = {"signal": signal, "label": np.int32(label)}
        if self.corrupt:
            variants = (self.precorrupted or {}).get(self.entries[index][0])
            if variants:
                k = int(rng.integers(len(variants)))
                vpath = variants[k]
                vmeta, _ = self._file_facts(vpath)
                if vmeta is not None and meta["crop"] is not None and self.max_segment_size:
                    # slice-read just the replay window; the scalar gain/flip
                    # commute bitwise with the crop (see _replay_transform)
                    wav = read_wav_slice(
                        vpath, vmeta, meta["crop"], meta["crop"] + self.max_segment_size
                    )
                    if meta["gain"] is not None:
                        wav = wav * meta["gain"]
                    if meta["flip"]:
                        wav = -wav
                    n = meta["final_len"]
                    if wav.shape[0] < n:
                        wav = np.pad(wav, (0, n - wav.shape[0]))
                    item["corrupted"] = wav[:n].astype(np.float32)
                else:
                    cor, _ = read_audio(vpath, self.sr)
                    item["corrupted"] = self._replay_transform(cor, meta)
            else:
                item["corrupted"] = corruption.corrupt(signal, self.sr, rng).astype(np.float32)
        return item


class SpeakerDataset(WaveDataset):
    """WaveDataset filtered to one speaker label (dataset.py:169-177)."""

    def __init__(self, speaker_id: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.entries = [e for e in self.entries if e[1] == speaker_id]


def collate(items: list[dict]) -> dict:
    """Stack items, zero-padding signals to the batch max (dataset.py:179-193)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if vals[0].ndim == 0:
            out[key] = np.stack(vals)
        else:
            max_len = max(v.shape[0] for v in vals)
            out[key] = np.stack(
                [np.pad(v, (0, max_len - v.shape[0])) for v in vals]
            )
    return out


# The dataset of this worker process (make_train_iterator's pool).
_worker_dataset: WaveDataset | None = None


def _init_worker(dataset: WaveDataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset


def _worker_item(index_epoch: tuple[int, int]) -> dict:
    index, epoch = index_epoch
    return _worker_dataset.__getitem__(index, epoch)


def make_train_iterator(
    dataset: WaveDataset,
    batch_size: int,
    num_workers: int = 8,
    prefetch: int = 4,
    seed: int = 1234,
    drop_remainder: bool = True,
):
    """Infinite epoch-aware iterator: ``num_workers`` worker processes
    decode and corrupt items, a thread collates and keeps ``prefetch``
    batches ready.

    Yields (epoch, batch dict of stacked numpy arrays). Shuffling reseeds per
    epoch like the reference's per-epoch np.random.seed (train.py:650-651).
    An error in a worker is raised by the next ``next``. ``close`` stops the
    workers. Each worker imports the caller's main module, as multiprocessing
    does: a script that calls this keeps its work under
    ``if __name__ == "__main__":``.
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n = len(dataset)
    steps = n // batch_size if drop_remainder else -(-n // batch_size)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            with ProcessPoolExecutor(max_workers=num_workers,
                                     mp_context=ctx,
                                     initializer=_init_worker,
                                     initargs=(dataset,)) as pool:
                epoch = 0
                while True:
                    order = np.random.default_rng(seed + epoch).permutation(n)
                    for s in range(steps):
                        idxs = order[s * batch_size : (s + 1) * batch_size]
                        items = list(pool.map(_worker_item, [(int(i), epoch) for i in idxs]))
                        if stop.is_set():
                            return
                        q.put((epoch, collate(items)))
                    epoch += 1
        except BaseException as err:  # handed to the consumer
            if not stop.is_set():
                q.put(err)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            item = q.get()
            if isinstance(item, BaseException):
                raise RuntimeError("the training data pipeline failed") from item
            return item

        def close(self):
            """Stop the producer and its worker processes: it finishes the
            batch it is making and returns. Emptying the queue frees a
            producer that is blocked on a full one. Then end the fork
            server, which outlives the pool and would otherwise outlive
            this process too; the next iterator starts a new one."""
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
            from multiprocessing import forkserver
            forkserver._forkserver._stop()

    return _Iter()
