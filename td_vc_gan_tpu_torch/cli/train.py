"""Training CLI of the port; the arguments of ``td_vc_gan_tpu/cli/train.py``
(the reference's train.py:48-56) plus ``--device``.

Usage:
    python -m td_vc_gan_tpu_torch.cli.train --save_path runs/exp --data_path data/vctk \
        [--config_file config.yaml] [--override train.batch_size=16 ...] \
        [--load_path runs/exp] [--epoch N] [--device cuda|cpu]

``--override`` values are JSON (numbers, true/false, null, lists), else raw
strings; no PyYAML is needed unless ``--config_file`` is a YAML file.
"""

from __future__ import annotations

import argparse

import torch

from td_vc_gan_tpu_torch.config import load_config, parse_overrides
from td_vc_gan_tpu_torch.training.loop import train


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--load_path", default=None)
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--epoch", default=None)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps")
    parser.add_argument("--crepe_weights", default=None,
                        help="torchcrepe .pth to import for the pitch net")
    parser.add_argument("--precorrupted_index", default=None,
                        help="precorrupt_index.pkl: serve stored corruption variants "
                             "instead of corrupting on the fly")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of steps 10-15 here")
    parser.add_argument("--wavlm_checkpoint", default=None,
                        help="not ported yet (the WavLM encoder)")
    parser.add_argument("--override", action="append", default=[],
                        help="dotted config override, e.g. train.batch_size=4")
    parser.add_argument("--coordinator_address", default=None,
                        help="not ported yet (multi-process training)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="not ported yet: only 1")
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    if args.num_processes and args.num_processes > 1:
        parser.error("--num_processes > 1: multi-process training is not ported yet")
    if args.wavlm_checkpoint:
        parser.error("--wavlm_checkpoint: the WavLM encoder is not ported yet")
    return args


def main(argv=None):
    args = parse_args(argv)
    # f32 throughout, as the JAX package's default: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config_file, parse_overrides(args.override))
    train(
        cfg,
        save_path=args.save_path,
        data_path=args.data_path,
        load_path=args.load_path,
        epoch=args.epoch,
        config_file=args.config_file,
        max_steps=args.max_steps,
        crepe_weights=args.crepe_weights,
        profile_dir=args.profile_dir,
        precorrupted_index=args.precorrupted_index,
        device=args.device,
    )


if __name__ == "__main__":
    main()
