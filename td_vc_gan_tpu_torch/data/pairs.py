"""Fixed conversion-pair dataset (data/pairs_dataset.py:17-53).

The port's own copy of ``td_vc_gan_tpu/data/pairs.py``.

Manifest format: ``conv_name|source_path|target_path`` lines; source/target
labels are looked up from the regular ``path|speaker`` labels manifest.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from td_vc_gan_tpu_torch.data.dataset import WaveDataset


class PairsDataset(WaveDataset):
    def __init__(self, pairs_file: str | Path, labels_file: str | Path, speaker_file, **kwargs):
        super().__init__(labels_file, speaker_file, **kwargs)
        self.labels_lookup = {filename: label for filename, label in self.entries}
        with open(pairs_file) as f:
            self.pairs = [line.strip().split("|") for line in f if line.strip()]
        self._path_index = {p: i for i, (p, _) in enumerate(self.entries)}

    def __len__(self) -> int:
        return len(self.pairs)

    def get_convname(self, index: int) -> str:
        return self.pairs[index][0]

    def __getitem__(self, index: int, epoch: int = 0) -> dict:
        conv_name, src_path, tgt_path = self.pairs[index]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, index]))
        src = self.load_signal(self._path_index[src_path], rng)
        tgt = self.load_signal(self._path_index[tgt_path], rng)
        return {
            "conv_name": conv_name,
            "source": src,
            "source_label": np.int32(self.spk_dict[self.labels_lookup[src_path]]),
            "target": tgt,
            "target_label": np.int32(self.spk_dict[self.labels_lookup[tgt_path]]),
        }
