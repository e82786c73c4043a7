"""Data parallelism over ``torch.distributed``: one process (a rank) per GPU.

Counterpart of ``td_vc_gan_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a 1-D ('data',) mesh: parameters replicated, batches
sharded on axis 0, gradients summed by the psum XLA inserts, hosts joined by
``jax.distributed``. Here every rank holds a replica of the parameters and
its slice of the global batch; the train step averages the gradients across
ranks before each optimizer update (:func:`mean_`) and gathers the few
per-item numbers its global permutation reads (:func:`gather_rows`).

All-reduce is the only collective. Gloo takes only broadcast and all-reduce
on CUDA tensors, so with it two ranks can share one card (NCCL refuses
that), which is how one card checks the cross-rank step against one rank
(``chip_smoke.py`` joins such a group through ``testing.step_rank``).
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from td_vc_gan_tpu_torch import resolve_device

# How long a collective or the rendezvous waits for the other ranks; long
# enough for a rank-0 save of a WavLM train state (~1.3 GB) or a kernel build.
TIMEOUT = timedelta(minutes=30)
# Elements per all-reduce of packed gradients (64 MiB of f32): G's 14.6 M and
# D's 17.8 M parameters at full width take one or two calls each.
BUCKET = 1 << 24


def initialize_multihost(coordinator_address: str | None, num_processes: int | None,
                         process_id: int | None, device=None) -> None:
    """Join the process group of ``num_processes`` ranks at
    ``tcp://coordinator_address`` (``host:port`` of rank 0) as rank
    ``process_id``, waiting up to ``TIMEOUT`` for the others; nothing when
    ``num_processes`` is 1 or less. Call it before any CUDA use. The
    backend is NCCL for a CUDA ``device`` (default: the card; made the
    current device) and gloo for the CPU."""
    if num_processes is None or num_processes <= 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def rank_world(group=None) -> tuple[int, int]:
    """(this process's rank, the number of ranks) in ``group`` (default: the
    whole process group); (0, 1) when no process group was joined."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_batch(batch_size: int, world: int) -> int:
    """Each rank's share of a global batch; the equal shares make the mean
    of the ranks' batch means the global batch mean."""
    if batch_size % world:
        raise ValueError(f"train.batch_size={batch_size} must divide by the {world} ranks "
                         f"for per-rank input sharding")
    return batch_size // world


def mean_(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor, in place, by its mean across the ranks: packed
    into flat f32 buffers of at most ``BUCKET`` elements, one all-reduce
    (sum) each, then divided by the number of ranks."""
    world = dist.get_world_size(group)
    buckets, size = [[]], 0
    for t in tensors:
        if buckets[-1] and size + t.numel() > BUCKET:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    for part in buckets:
        if not part:
            continue
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in part])
        dist.all_reduce(flat, group=group)
        flat /= world
        offset = 0
        for t in part:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_metrics(metrics: dict, group=None) -> dict:
    """The 0-d metric tensors averaged across the ranks, in one all-reduce."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(keys, flat.unbind(0)))


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of a per-item tensor, rank order: (b, ...) on each
    rank -> (world * b, ...). An all-reduce (sum) of a zero-padded global
    buffer, in which each rank fills its own rows: exact, since every other
    term of each sum is zero."""
    rank, world = rank_world(group)
    b = x.shape[0]
    out = x.new_zeros((world * b, *x.shape[1:]))
    out[rank * b:(rank + 1) * b] = x
    dist.all_reduce(out, group=group)
    return out


def barrier(device, group=None) -> None:
    """Wait until every rank is here: an all-reduce of one element on
    ``device``, read back on the host."""
    t = torch.ones(1, device=device)
    dist.all_reduce(t, group=group)
    t.item()


def check_replicas(digest: str, device, group=None) -> None:
    """Raise unless every rank passed the same hex ``digest`` (of its train
    state): the ranks' replicas must start equal, since every later update
    applies the same averaged gradients to each."""
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.int64, device=device)
    rows = gather_rows(mine[None], group)
    differ = [r for r in range(rows.shape[0]) if not torch.equal(rows[r], mine)]
    if differ:
        rank, world = rank_world(group)
        raise RuntimeError(f"rank {rank}/{world}: the train state differs from that of ranks "
                           f"{differ} (digest {digest})")


def local_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` (default: all) CUDA devices of this host, for
    ``Converter.convert_long_sharded``; the counterpart of ``create_mesh``.
    A machine without a card raises (pass CPU devices explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=['cpu', ...] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:n]
