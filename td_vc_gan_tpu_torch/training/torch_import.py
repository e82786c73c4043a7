"""Third-party pretrained torch weights into the port's models.

Counterpart of ``td_vc_gan_tpu/training/torch_import.py`` (CREPE only; the
WavLM encoder is not ported yet). The port's CREPE keeps torch's layouts, so
only the names change.
"""

from __future__ import annotations

import torch

from td_vc_gan_tpu_torch.models.crepe import _BASE_CHANNELS, _CAPACITY, Crepe


def load_torchcrepe(path) -> Crepe:
    """torchcrepe ``tiny.pth``/``full.pth`` -> the port's :class:`Crepe` (on
    the CPU), its capacity read from the first conv's width.

    torchcrepe layout: conv{1..6}.weight (out, in, k, 1), conv{1..6}.bias,
    conv{1..6}_BN.{weight,bias,running_mean,running_var},
    classifier.{weight,bias}.
    """
    sd = torch.load(path, map_location="cpu", weights_only=False)
    state = {}
    for i in range(6):
        t = i + 1
        state[f"conv{i}_kernel"] = sd[f"conv{t}.weight"][..., 0]
        state[f"conv{i}_bias"] = sd[f"conv{t}.bias"]
        state[f"bn{i}.scale"] = sd[f"conv{t}_BN.weight"]
        state[f"bn{i}.bias"] = sd[f"conv{t}_BN.bias"]
        state[f"bn{i}.mean"] = sd[f"conv{t}_BN.running_mean"]
        state[f"bn{i}.var"] = sd[f"conv{t}_BN.running_var"]
    state["classifier_kernel"] = sd["classifier.weight"]
    state["classifier_bias"] = sd["classifier.bias"]
    width = sd["conv1.weight"].shape[0]
    model = next((m for m, cap in _CAPACITY.items() if _BASE_CHANNELS[0] * cap == width), None)
    if model is None:
        raise ValueError(f"{path}: a first conv of {width} channels is neither CREPE tiny "
                         "nor full")
    net = Crepe(model)
    net.load_state_dict({k: v.detach().to(torch.float32).contiguous() for k, v in state.items()})
    return net
