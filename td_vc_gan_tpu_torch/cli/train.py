"""Training CLI of the port; the arguments of ``td_vc_gan_tpu/cli/train.py``
(the reference's train.py:48-56) plus ``--device``.

Usage:
    python -m td_vc_gan_tpu_torch.cli.train --save_path runs/exp --data_path data/vctk \
        [--config_file config.yaml] [--override train.batch_size=16 ...] \
        [--load_path runs/exp] [--epoch N] [--wavlm_checkpoint WavLM-Large.pt] \
        [--device cuda|cpu]

``--override`` values are JSON (numbers, true/false, null, lists), else raw
strings; no PyYAML is needed unless ``--config_file`` is a YAML file.

Data-parallel training runs one such command per GPU, each with the same
arguments and its own ``--process_id`` (its rank, from 0), joined at
``--coordinator_address`` (``host:port`` of rank 0) over NCCL, or gloo with
``--device cpu``. Each takes ``cuda:{process_id %
device_count}`` unless ``--device`` names a device. ``train.batch_size`` is
the global batch: it must divide by the number of processes. For 8 GPUs of
one host::

    for r in 0 1 2 3 4 5 6 7; do
        python -m td_vc_gan_tpu_torch.cli.train --save_path runs/exp --data_path data/vctk \
            --num_processes 8 --process_id $r --coordinator_address 127.0.0.1:29500 &
    done; wait
"""

from __future__ import annotations

import argparse

import torch

from td_vc_gan_tpu_torch import parallel
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
                        help="Microsoft WavLM .pt (WavLM-Large.pt) for the frozen backbone "
                             "of a wavlm config; without it the backbone comes from the seed")
    parser.add_argument("--override", action="append", default=[],
                        help="dotted config override, e.g. train.batch_size=4")
    # data-parallel launch: one process per GPU, each running this same CLI
    # with its own --process_id
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 for torch.distributed")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="total processes, one per GPU (enables torch.distributed)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's index (0-based), its rank")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card, cuda:{process_id %% "
                             "device_count} in a multi-process run; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    if args.num_processes and args.num_processes > 1 and (
            args.coordinator_address is None or args.process_id is None):
        parser.error("--num_processes > 1 requires --coordinator_address "
                     "and --process_id (torch.distributed would otherwise "
                     "have no rendezvous)")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = args.device
    multi = bool(args.num_processes and args.num_processes > 1)
    if multi and device is None and torch.cuda.is_available():
        device = f"cuda:{args.process_id % torch.cuda.device_count()}"
    # must run before any CUDA use in this process
    parallel.initialize_multihost(args.coordinator_address, args.num_processes,
                                  args.process_id, device)
    # f32 throughout, as the JAX package's default: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config_file, parse_overrides(args.override))
    try:
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
            wavlm_checkpoint=args.wavlm_checkpoint,
            device=device,
        )
    finally:
        if multi:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
