"""FiLM conditioning chain of one MRF stage: hand-written CUDA kernels + plain versions.

Every FiLM block of an MRF stage conditions on the same per-stage tensor
through its own ``cond_0`` (k=3) -> leaky_relu -> ``cond_1`` (k=3) convs. All
n blocks' chains run as one op: ``cond_0`` of every block as one wide conv
(n*Cc output columns), then each block's ``cond_1`` on its Cc-column slice.
Output columns ``[i*2C, (i+1)*2C)`` hold block i's (gamma, beta), gamma first.

Two forms, one pair of kernels:

- :func:`cond_chain`, the split form the decoder uses: the conditioning is a
  time-constant speaker embedding plus an E-channel excitation, so ``cond_0``
  is a conv over the excitation plus a per-batch bias, corrected at rows 0 and
  T-1 where the speaker taps meet the zero pad.
- :func:`film_cond_chain`, the concat form with the JAX signature: the split
  form with the whole conditioning as the "excitation", ``b0`` as the bias and
  no edge corrections.

The forward (K1, ``csrc/cond_chain.cu``) replaces
``td_vc_gan_tpu/ops/pallas/cond_chain.py::_fwd_kernel``; the backward (K2,
``csrc/cond_chain_bwd.cu``) replaces its ``_bwd_kernel``. Both run their
products on the tensor cores as 3xTF32 (``csrc/tf32x3.cuh``: f32 accuracy
from TF32 ``mma.sync`` tiles) and share cond_0's recompute
(``csrc/cond_chain_h.cuh``). Both are tied
together by :class:`CondChain`, an ``autograd.Function``: CUDA tensors launch
the kernels (or raise for what they do not take), CPU tensors run
:func:`cond_chain_plain` and :func:`cond_chain_bwd_plain`. Layouts are
channels-last, as in the JAX package: ``exc (B, T, E)``, ``w0 (3, E, n*Cc)``,
``w1 (3, Cc, n*2C)``, output ``(B, T, n*2C)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from td_vc_gan_tpu_torch.ops.activation import LEAKY_RELU_SLOPE, leaky_relu

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = _CSRC / "cond_chain.cu"
BWD_SOURCE = _CSRC / "cond_chain_bwd.cu"
SOURCES = (SOURCE, BWD_SOURCE)
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches since the last reset (forward: ``launches``, backward:
# ``bwd_launches``, one per backward call of the chain however many CUDA
# kernels it runs); chip_smoke.py reads them to show that the main path went
# through the kernels.
launches = 0
bwd_launches = 0

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the cond-chain kernels are built from "
                       f"{_CSRC} on a machine with the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources_of(source: Path) -> list[Path]:
    """``source`` and every header it includes with ``#include "..."``,
    recursively, each once, in the order they are first met."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / name for name in _INCLUDE.findall(path.read_text())]
    return seen


def _lib_path(source: Path) -> Path:
    """The library built from ``source``, keyed by the bytes of the source,
    of every header it includes and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources_of(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build() -> tuple[list[Path], float, str]:
    """Compile each kernel source into its own library in ``csrc/build/``
    (keyed by the hash of the source and its headers), all ``nvcc`` runs
    started together, unless a library built from the same files is there.
    Returns (library paths, build seconds, nvcc's output); the seconds are 0
    when nothing was built."""
    libs = [_lib_path(src) for src in SOURCES]
    todo = [(src, lib) for src, lib in zip(SOURCES, libs) if not lib.exists()]
    if not todo:
        return libs, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        log.append(f"{src.name}: {out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0, "\n".join(log)


def _library():
    global _lib
    if _lib is None:
        (fwd_path, bwd_path), _, _ = build()
        p = ctypes.c_void_p
        i = ctypes.c_int
        fwd = ctypes.CDLL(str(fwd_path))
        fwd.cond_chain_fwd_f32.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, p, p,
                                           i, i, i, i, i, i, p]
        fwd.cond_chain_fwd_f32.restype = i
        fwd.cond_chain_fwd_tile.argtypes = [i, i, i]
        fwd.cond_chain_fwd_tile.restype = i
        fwd.cond_chain_error_string.argtypes = [i]
        fwd.cond_chain_error_string.restype = ctypes.c_char_p
        bwd = ctypes.CDLL(str(bwd_path))
        bwd.cond_chain_bwd_rows.argtypes = [i, i, i, i, i, i]
        bwd.cond_chain_bwd_rows.restype = i
        bwd.cond_chain_bwd_workspace.argtypes = [i, i, i, i, i, i]
        bwd.cond_chain_bwd_workspace.restype = ctypes.c_longlong
        bwd.cond_chain_bwd_f32.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, p,
                                           p, p, p, p, p, p, p,
                                           p, ctypes.c_longlong, i, i, i, i, i, i, p]
        bwd.cond_chain_bwd_f32.restype = i
        _lib = (fwd, bwd)
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


def _h_plain(exc, w0, hbias, edge0, edge_t, n, cc):
    """cond_0's pre-activation (B, n*Cc, T): conv1d over ``exc``, bias and
    edge fixes."""
    t = exc.shape[1]
    h = F.conv1d(exc.transpose(1, 2), w0.permute(2, 1, 0), padding=1)
    h = h + hbias.reshape(-1, n * cc, 1)
    if edge0 is not None:
        fix = torch.zeros_like(h)
        fix[:, :, 0] = edge0
        fix[:, :, t - 1] += edge_t
        h = h - fix
    return h


def cond_chain_plain(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """The chain in plain PyTorch: conv1d over ``exc``, bias and edge fixes,
    leaky_relu, then the n per-block convs as one grouped conv1d. Under
    autograd its leaky_relu takes the slope 1 at h = 0, as K2 and the JAX
    package do.

    ``hbias`` is (B, n*Cc) or (n*Cc,); ``edge0``/``edge_t`` (B, n*Cc) are
    subtracted at rows 0 and T-1 when given.
    """
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    a = leaky_relu(_h_plain(exc, w0, hbias, edge0, edge_t, n, cc), LEAKY_RELU_SLOPE)
    out = F.conv1d(a, w1.permute(2, 1, 0), b1, padding=1, groups=n)
    return out.transpose(1, 2).contiguous()


def _taps(x, t):
    """The three k=3 'same' windows of x (B, C, T), zero outside [0, T):
    window j holds x[..., s + j - 1] at s."""
    xp = F.pad(x, (1, 1))
    return [xp[..., j:j + t] for j in range(3)]


def cond_chain_bwd_plain(exc, w0, hbias, w1, g, edge0=None, edge_t=None):
    """The chain's backward in plain PyTorch, step by step as K2 computes it.

    Given g = d(out) (B, T, n*2C) it recomputes a = lrelu(h), then
    da = g conv_transpose blockdiag(W1), dh = lrelu'(h) da,
    d``exc`` = dh conv_transpose W0, and the weight and bias grads as sums
    over every (batch row, time) pair. Returns a dict with ``exc``, ``w0``,
    ``hbias`` (shaped as ``hbias``), ``w1``, ``b1`` and, when the edges are
    given, ``edge0``/``edge_t`` (-dh at rows 0 and T-1).
    """
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    h = _h_plain(exc, w0, hbias, edge0, edge_t, n, cc)          # (B, n*Cc, T)
    a = F.leaky_relu(h, LEAKY_RELU_SLOPE)
    gt = g.transpose(1, 2)                                       # (B, n*2C, T)
    da = F.conv_transpose1d(gt, w1.permute(2, 1, 0), padding=1, groups=n)
    dh = torch.where(h >= 0, da, LEAKY_RELU_SLOPE * da)
    dexc = F.conv_transpose1d(dh, w0.permute(2, 1, 0), padding=1)
    a_taps, x_taps = _taps(a, t), _taps(exc.transpose(1, 2), t)
    gb = gt.reshape(b, n, two_c, t)
    dw1 = torch.stack([torch.einsum("bnct,bnot->cno", aj.reshape(b, n, cc, t), gb)
                       .reshape(cc, n * two_c) for aj in a_taps])
    dw0 = torch.stack([torch.einsum("bet,bkt->ek", xj, dh) for xj in x_taps])
    dhb = dh.sum(-1)
    out = dict(exc=dexc.transpose(1, 2).contiguous(), w0=dw0,
               hbias=dhb if hbias.dim() == 2 else dhb.sum(0), w1=dw1, b1=gt.sum((0, 2)))
    if edge0 is not None:
        out.update(edge0=-dh[:, :, 0], edge_t=-dh[:, :, t - 1])
    return out


def _check_cuda(name, x, device):
    if x.device != device:
        raise ValueError(f"cond chain: {name} is on {x.device}, exc on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"cond chain kernel takes float32, {name} is {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cond chain kernel takes contiguous tensors; {name} is not")


def _check_operands(exc, w0, hbias, w1, b1, edge0, edge_t):
    """Shapes, device, dtype and contiguity the kernels take; (B, T, E, n,
    Cc, 2C). ``b1`` may be None (the backward does not read it)."""
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    if two_c % 4 or two_c > 1024 or cc % 4:
        raise ValueError(f"cond chain kernels take 2C a multiple of 4 up to 1024 and Cc a "
                         f"multiple of 4, got 2C={two_c}, Cc={cc}")
    dev = exc.device
    ops = {"exc": exc, "w0": w0, "hbias": hbias, "w1": w1}
    if b1 is not None:
        ops.update(b1=b1)
    if edge0 is not None:
        ops.update(edge0=edge0, edge_t=edge_t)
    for name, x in ops.items():
        _check_cuda(name, x, dev)
    if hbias.shape not in ((b, n * cc), (n * cc,)) or (
            b1 is not None and b1.shape != (n * two_c,)):
        raise ValueError(f"cond chain bias shapes {tuple(hbias.shape)} / "
                         f"{None if b1 is None else tuple(b1.shape)}")
    if edge0 is not None and (edge0.shape != (b, n * cc) or edge_t.shape != (b, n * cc)):
        raise ValueError("cond chain edges must be (B, n*Cc)")
    return b, t, e, n, cc, two_c


# The kernels take a 128-row time tile, else a 64- or 32-row one where a
# wide Cc or E leaves the larger tile's shared memory over a block's 227 KB;
# each library says which tile it takes (0: none fits).
_NO_TILE = ("cond chain kernels: even a 32-row time tile at Cc={cc}, E={e} needs more "
            "than a block's 227 KB of shared memory")


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _error(lib, err):
    return lib.cond_chain_error_string(err).decode()


def _launch(exc, w0, hbias, w1, b1, edge0, edge_t):
    """K1: the forward kernel, (B, T, n*2C)."""
    global launches
    b, t, e, n, cc, two_c = _check_operands(exc, w0, hbias, w1, b1, edge0, edge_t)
    if w1.data_ptr() % 16:
        raise ValueError("cond chain kernel copies w1 in 16-byte pieces: it must be "
                         "16-byte aligned")
    fwd, _ = _library()
    if not fwd.cond_chain_fwd_tile(e, cc, two_c):
        raise ValueError(_NO_TILE.format(cc=cc, e=e))
    out = torch.empty((b, t, n * two_c), device=exc.device, dtype=torch.float32)
    err = fwd.cond_chain_fwd_f32(
        exc.data_ptr(), w0.data_ptr(), hbias.data_ptr(),
        n * cc if hbias.dim() == 2 else 0,
        edge0.data_ptr() if edge0 is not None else None,
        edge_t.data_ptr() if edge_t is not None else None,
        w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
        b, t, e, n, cc, two_c, _stream(exc.device))
    if err:
        raise RuntimeError("cond chain kernel launch failed: " + _error(fwd, err))
    launches += 1
    return out


def _launch_bwd(exc, w0, hbias, w1, g, edge0, edge_t):
    """K2: the backward kernels, the same dict as :func:`cond_chain_bwd_plain`."""
    global bwd_launches
    b, t, e, n, cc, two_c = _check_operands(exc, w0, hbias, w1, None, edge0, edge_t)
    _check_cuda("g", g, exc.device)
    if g.shape != (b, t, n * two_c):
        raise ValueError(f"cond chain cotangent {tuple(g.shape)} is not {(b, t, n * two_c)}")
    if (e % 4 == 0 and exc.data_ptr() % 16) or g.data_ptr() % 16:
        raise ValueError("cond chain backward kernels copy g, and exc when E is a multiple "
                         "of 4, in 16-byte pieces: they must be 16-byte aligned")
    fwd, bwd = _library()
    if not bwd.cond_chain_bwd_rows(b, t, e, n, cc, two_c):
        raise ValueError(_NO_TILE.format(cc=cc, e=e))
    dev = exc.device
    # (n, 3, 2C, Cc): block i's tap-j cond_1 kernel transposed, Cc contiguous,
    # the B operand of K2's da product
    w1t = w1.reshape(3, cc, n, two_c).permute(2, 0, 3, 1).contiguous()
    ws = torch.empty(int(bwd.cond_chain_bwd_workspace(b, t, e, n, cc, two_c)),
                     device=dev, dtype=torch.float32)
    out = dict(exc=torch.empty_like(exc), w0=torch.empty_like(w0),
               hbias=torch.empty_like(hbias), w1=torch.empty_like(w1),
               b1=torch.empty(n * two_c, device=dev, dtype=torch.float32))
    if edge0 is not None:
        out.update(edge0=torch.empty_like(edge0), edge_t=torch.empty_like(edge_t))
    err = bwd.cond_chain_bwd_f32(
        exc.data_ptr(), w0.data_ptr(), hbias.data_ptr(),
        n * cc if hbias.dim() == 2 else 0,
        edge0.data_ptr() if edge0 is not None else None,
        edge_t.data_ptr() if edge_t is not None else None,
        w1t.data_ptr(), g.data_ptr(),
        out["exc"].data_ptr(), out["w0"].data_ptr(), out["hbias"].data_ptr(),
        out["edge0"].data_ptr() if edge0 is not None else None,
        out["edge_t"].data_ptr() if edge0 is not None else None,
        out["w1"].data_ptr(), out["b1"].data_ptr(),
        ws.data_ptr(), ws.numel(), b, t, e, n, cc, two_c, _stream(dev))
    if err:
        raise RuntimeError("cond chain backward kernel launch failed: " + _error(fwd, err))
    bwd_launches += 1
    return out


def _use_kernels(exc) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (the plain
    versions); any other device raises."""
    if exc.is_cuda:
        return True
    if exc.device.type == "cpu":
        return False
    raise ValueError(f"cond chain runs on CUDA or the CPU, not {exc.device}")


class CondChain(torch.autograd.Function):
    """The chain with K1 as its forward and K2 as its backward on CUDA
    tensors; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, exc, w0, hbias, w1, b1, edge0, edge_t):
        ctx.save_for_backward(exc, w0, hbias, w1, edge0, edge_t)
        if _use_kernels(exc):
            return _launch(exc, w0, hbias, w1, b1, edge0, edge_t)
        return cond_chain_plain(exc, w0, hbias, w1, b1, edge0, edge_t)

    @staticmethod
    def backward(ctx, g):
        exc, w0, hbias, w1, edge0, edge_t = ctx.saved_tensors
        g = g.contiguous()
        if _use_kernels(exc):
            grads = _launch_bwd(exc, w0, hbias, w1, g, edge0, edge_t)
        else:
            grads = cond_chain_bwd_plain(exc, w0, hbias, w1, g, edge0, edge_t)
        return tuple(grads.get(k) if need else None for k, need in zip(
            ("exc", "w0", "hbias", "w1", "b1", "edge0", "edge_t"), ctx.needs_input_grad))


def cond_chain(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """All n blocks' (gamma, beta) of one stage, (B, T, n*2C), differentiable
    in every operand.

    CUDA tensors launch the kernels, CPU tensors run the plain versions; any
    other device raises. ``edge0`` and ``edge_t`` are given together or not
    at all.
    """
    if (edge0 is None) != (edge_t is None):
        raise ValueError("give both edge corrections or neither")
    _use_kernels(exc)
    return CondChain.apply(exc, w0, hbias, w1, b1, edge0, edge_t)


def film_cond_chain(c, w0, b0, w1, b1):
    """The concat form, with the signature of the JAX package's
    ``film_cond_chain``: c (B, T, Cc), w0 (3, Cc, n*Cc), b0 (n*Cc,),
    w1 (3, Cc, n*2C), b1 (n*2C,) -> (B, T, n*2C), without the TPU kernel's
    128-column padding."""
    return cond_chain(c, w0, b0, w1, b1)
