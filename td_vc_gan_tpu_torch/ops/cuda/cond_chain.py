"""FiLM conditioning chain of one MRF stage: hand-written CUDA kernel + plain version.

Every FiLM block of an MRF stage conditions on the same per-stage tensor
through its own ``cond_0`` (k=3) -> leaky_relu -> ``cond_1`` (k=3) convs. All
n blocks' chains run as one op: ``cond_0`` of every block as one wide conv
(n*Cc output columns), then each block's ``cond_1`` on its Cc-column slice.
Output columns ``[i*2C, (i+1)*2C)`` hold block i's (gamma, beta), gamma first.

Two forms, one kernel (``csrc/cond_chain.cu``, replacing
``td_vc_gan_tpu/ops/pallas/cond_chain.py::_fwd_kernel``):

- :func:`cond_chain`, the split form the decoder uses: the conditioning is a
  time-constant speaker embedding plus an E-channel excitation, so ``cond_0``
  is a conv over the excitation plus a per-batch bias, corrected at rows 0 and
  T-1 where the speaker taps meet the zero pad.
- :func:`film_cond_chain`, the concat form with the JAX signature: the split
  form with the whole conditioning as the "excitation", ``b0`` as the bias and
  no edge corrections.

CUDA tensors launch the kernel (or raise for what it does not take); CPU
tensors run :func:`cond_chain_plain`. Layouts are channels-last, as in the JAX
package: ``exc (B, T, E)``, ``w0 (3, E, n*Cc)``, ``w1 (3, Cc, n*2C)``, output
``(B, T, n*2C)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = _CSRC / "cond_chain.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path went through the kernel.
launches = 0

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the cond-chain kernel is built from "
                       f"{SOURCE} on a machine with the CUDA toolkit")


def build() -> tuple[Path, float, str]:
    """Compile the kernel into ``csrc/build/`` unless a library built from
    the same source is there. Returns (library path, build seconds, nvcc's
    output); the seconds are 0 when nothing was built."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"cond_chain_{tag}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.cond_chain_fwd_f32.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, p, p,
                                           i, i, i, i, i, i, p]
        lib.cond_chain_fwd_f32.restype = i
        lib.cond_chain_error_string.argtypes = [i]
        lib.cond_chain_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _dims(exc, w0, w1):
    """(B, T, E, n, Cc, 2C) from the operand shapes, or ValueError."""
    if exc.dim() != 3 or w0.dim() != 3 or w1.dim() != 3:
        raise ValueError("cond chain expects exc (B,T,E), w0 (3,E,n*Cc), w1 (3,Cc,n*2C)")
    b, t, e = exc.shape
    cc = w1.shape[1]
    if w0.shape[0] != 3 or w1.shape[0] != 3 or w0.shape[1] != e or w0.shape[2] % cc:
        raise ValueError(f"cond chain weight shapes {tuple(w0.shape)} / "
                         f"{tuple(w1.shape)} do not fit exc {tuple(exc.shape)}")
    n = w0.shape[2] // cc
    if w1.shape[2] % n:
        raise ValueError(f"w1 width {w1.shape[2]} is not a multiple of n={n}")
    return b, t, e, n, cc, w1.shape[2] // n


def cond_chain_plain(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """The chain in plain PyTorch: conv1d over ``exc``, bias and edge fixes,
    leaky_relu, then the n per-block convs as one grouped conv1d.

    ``hbias`` is (B, n*Cc) or (n*Cc,); ``edge0``/``edge_t`` (B, n*Cc) are
    subtracted at rows 0 and T-1 when given.
    """
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    h = F.conv1d(exc.transpose(1, 2), w0.permute(2, 1, 0), padding=1)
    h = h + hbias.reshape(-1, n * cc, 1)
    if edge0 is not None:
        h[:, :, 0] -= edge0
        h[:, :, t - 1] -= edge_t
    a = F.leaky_relu(h, LEAKY_SLOPE)
    out = F.conv1d(a, w1.permute(2, 1, 0), b1, padding=1, groups=n)
    return out.transpose(1, 2).contiguous()


def _check_cuda(name, x, device):
    if x.device != device:
        raise ValueError(f"cond chain: {name} is on {x.device}, exc on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"cond chain kernel takes float32, {name} is {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cond chain kernel takes contiguous tensors; {name} is not")


def _launch(exc, w0, hbias, w1, b1, edge0, edge_t):
    global launches
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    if two_c % 4 or two_c > 1024:
        raise ValueError(f"cond chain kernel takes 2C a multiple of 4 up to 1024, got {two_c}")
    dev = exc.device
    ops = {"exc": exc, "w0": w0, "hbias": hbias, "w1": w1, "b1": b1}
    if edge0 is not None:
        ops.update(edge0=edge0, edge_t=edge_t)
    for name, x in ops.items():
        _check_cuda(name, x, dev)
    if hbias.shape not in ((b, n * cc), (n * cc,)) or b1.shape != (n * two_c,):
        raise ValueError(f"cond chain bias shapes {tuple(hbias.shape)} / {tuple(b1.shape)}")
    if edge0 is not None and (edge0.shape != (b, n * cc) or edge_t.shape != (b, n * cc)):
        raise ValueError("cond chain edges must be (B, n*Cc)")
    if w1.data_ptr() % 16:
        raise ValueError("cond chain kernel reads w1 as float4: it must be 16-byte aligned")
    lib = _library()
    out = torch.empty((b, t, n * two_c), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cond_chain_fwd_f32(
        exc.data_ptr(), w0.data_ptr(), hbias.data_ptr(),
        n * cc if hbias.dim() == 2 else 0,
        edge0.data_ptr() if edge0 is not None else None,
        edge_t.data_ptr() if edge_t is not None else None,
        w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
        b, t, e, n, cc, two_c, stream)
    if err:
        raise RuntimeError("cond chain kernel launch failed: "
                           + lib.cond_chain_error_string(err).decode())
    launches += 1
    return out


def cond_chain(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """All n blocks' (gamma, beta) of one stage, (B, T, n*2C).

    CUDA tensors launch the kernel, CPU tensors run :func:`cond_chain_plain`;
    any other device raises. ``edge0`` and ``edge_t`` are given together or
    not at all.
    """
    if (edge0 is None) != (edge_t is None):
        raise ValueError("give both edge corrections or neither")
    if exc.is_cuda:
        return _launch(exc, w0, hbias, w1, b1, edge0, edge_t)
    if exc.device.type == "cpu":
        return cond_chain_plain(exc, w0, hbias, w1, b1, edge0, edge_t)
    raise ValueError(f"cond chain runs on CUDA or the CPU, not {exc.device}")


def film_cond_chain(c, w0, b0, w1, b1):
    """The concat form, with the signature of the JAX package's
    ``film_cond_chain``: c (B, T, Cc), w0 (3, Cc, n*Cc), b0 (n*Cc,),
    w1 (3, Cc, n*2C), b1 (n*2C,) -> (B, T, n*2C), without the TPU kernel's
    128-column padding."""
    return cond_chain(c, w0, b0, w1, b1)
