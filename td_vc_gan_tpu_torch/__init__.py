"""PyTorch/CUDA port of td_vc_gan_tpu (conversion slice).

The package imports torch, numpy and scipy only. Its entry points
(:class:`inference.Converter`, :func:`models.generator.generator_from_config`)
run on the CUDA card unless the caller passes ``device="cpu"``. torch is
imported where it is used, so that the host-only CLIs (``prepare_dataset``,
``subset_dataset``, ``merge_datasets``, ``get_model_info``) start without it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; a machine without one raises rather than
    moving to the CPU behind the caller's back."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
