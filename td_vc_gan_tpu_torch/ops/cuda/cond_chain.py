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
from TF32 products). K1 and K2's data kernel are Hopper kernels: ``wgmma``
on operands that bulk and TMA copies bring through ``mbarrier`` rings
(``csrc/cond_chain_f32.cuh``, ``csrc/hopper_bf16.cuh``), on images of the
weights the libraries make at each launch in a workspace the wrapper
allocates; K2's weight grads recompute lrelu(h) at the decoder's E = 8
rather than read it from a scratch (past E = 9, E = 8 in bf16, the data
kernel writes one), and take dW0, dhbias and the edges as one product (in
K2's data kernel itself at E <= 9, with no scratch of dh). Both are
tied together by :class:`CondChain`, an ``autograd.Function``: CUDA tensors
launch the kernels (or raise for a device, dtype or layout they do not
take), CPU tensors run :func:`cond_chain_plain` and
:func:`cond_chain_bwd_plain`. Layouts are channels-last, as in the JAX
package: ``exc (B, T, E)``, ``w0 (3, E, n*Cc)``, ``w1 (3, Cc, n*2C)``, output
``(B, T, n*2C)``.

Every width runs through the kernels, as every width runs in the JAX
package: none of the four kernels' shared memory grows with Cc or E (passes
of 136 channels of h). Where a kernel takes Cc or 2C in multiples only
(``_GRAIN``), the wrapper pads each block's channels with zeros and cuts the
results back (:func:`_pad_widths`, :func:`_cut_grads`; exact: a zero
channel of h is zero after leaky_relu, and zero rows or columns of W1 add
nothing); K1-bf16 takes E in multiples too (:func:`_padded_e`; exc and W0
padded with zero channels, which add nothing to h).

The operands are all float32 or all bfloat16 (the JAX package's bf16
compute scope). bfloat16 operands take the kernels' bf16 instances, K1-bf16
(``csrc/cond_chain_bf16.cu``) and K2-bf16 (``csrc/cond_chain_bwd_bf16.cu``):
Hopper kernels whose products run on ``wgmma`` with f32 accumulators and
whose operands come by TMA through a ring of ``mbarrier`` stages
(``csrc/hopper_bf16.cuh``; what both share, ``csrc/cond_chain_bf16.cuh``),
with tensor maps the libraries encode at each launch and images of the
weights they make in a workspace the wrapper allocates. They round where the
Pallas kernels round their bf16 instance: lrelu(h) once before the second
product, the output once; in the backward dh and dexc once each, and every
weight and bias gradient summed in f32 and rounded once. The plain versions
round at the same points.
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
BF16_SOURCES = (_CSRC / "cond_chain_bf16.cu", _CSRC / "cond_chain_bwd_bf16.cu")
_LIBS = ("fwd", "bwd", "fwd_bf16", "bwd_bf16")  # the libraries of SOURCES + BF16_SOURCES
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches since the last reset (forward: ``launches``, backward:
# ``bwd_launches``, one per backward call of the chain however many CUDA
# kernels it runs; ``*_bf16`` for the bf16 instances); chip_smoke.py reads
# them to show that the main path went through the kernels.
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0


def kernel_launches(compute_dtype: str = "float32") -> tuple[int, int]:
    """(K1, K2) launches so far of the instances a ``train.compute_dtype``
    runs."""
    if compute_dtype == "bfloat16":
        return launches_bf16, bwd_launches_bf16
    return launches, bwd_launches

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
    """Compile each kernel source (``SOURCES``, then ``BF16_SOURCES``) into
    its own library in ``csrc/build/`` (keyed by the hash of the source and
    its headers), all ``nvcc`` runs started together, unless a library built
    from the same files is there. Returns (library paths, build seconds,
    nvcc's output); the seconds are 0 when nothing was built."""
    sources = SOURCES + BF16_SOURCES
    libs = [_lib_path(src) for src in sources]
    todo = [(src, lib) for src, lib in zip(sources, libs) if not lib.exists()]
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


def _library() -> dict:
    """The four kernel libraries, built at first use: ``fwd`` (K1), ``bwd``
    (K2), ``fwd_bf16`` and ``bwd_bf16`` (their bf16 instances)."""
    global _lib
    if _lib is None:
        paths, _, _ = build()
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        libs = {name: ctypes.CDLL(str(path)) for name, path in zip(_LIBS, paths)}
        for name in ("fwd", "fwd_bf16"):
            libs[name].cond_chain_error_string.argtypes = [i]
            libs[name].cond_chain_error_string.restype = ctypes.c_char_p
        libs["fwd"].cond_chain_fwd_f32.argtypes = [p, p, p, ll, p, p, p, p, p, p, ll,
                                                   i, i, i, i, i, i, p]
        libs["fwd"].cond_chain_fwd_f32.restype = i
        libs["fwd"].cond_chain_fwd_f32_workspace.argtypes = [i, i, i, i, i, i]
        libs["fwd"].cond_chain_fwd_f32_workspace.restype = ll
        libs["fwd_bf16"].cond_chain_fwd_bf16.argtypes = [p, p, p, ll, p, p, p, p, p, p, ll,
                                                         i, i, i, i, i, i, p]
        libs["fwd_bf16"].cond_chain_fwd_bf16.restype = i
        libs["fwd_bf16"].cond_chain_fwd_bf16_workspace.argtypes = [i, i, i, i, i]
        libs["fwd_bf16"].cond_chain_fwd_bf16_workspace.restype = ll
        libs["fwd_bf16"].cond_chain_fwd_bf16_tile.argtypes = [i, i, i]
        libs["fwd_bf16"].cond_chain_fwd_bf16_tile.restype = i
        bwd = libs["bwd"]
        bwd.cond_chain_bwd_workspace.argtypes = [i, i, i, i, i, i, i]
        bwd.cond_chain_bwd_workspace.restype = ll
        bwd.cond_chain_bwd_f32.argtypes = [p, p, p, ll, p, p, p, p,
                                           p, p, p, p, p, p, p,
                                           p, ll, i, i, i, i, i, i, p]
        bwd.cond_chain_bwd_f32.restype = i
        bwd.cond_chain_bwd_time_kernels.argtypes = [i]
        bwd.cond_chain_bwd_time_kernels.restype = i
        bwd.cond_chain_bwd_kernel_ms.argtypes = [ctypes.POINTER(ctypes.c_float)]
        bwd.cond_chain_bwd_kernel_ms.restype = i
        bwd.cond_chain_bwd_launched.argtypes = []
        bwd.cond_chain_bwd_launched.restype = i
        bwd = libs["bwd_bf16"]
        bwd.cond_chain_bwd_bf16_rows.argtypes = [i, i, i, i, i, i]
        bwd.cond_chain_bwd_bf16_rows.restype = i
        bwd.cond_chain_bwd_bf16_workspace.argtypes = [i, i, i, i, i, i]
        bwd.cond_chain_bwd_bf16_workspace.restype = ll
        bwd.cond_chain_bwd_bf16.argtypes = [p, p, p, ll, p, p, p, p,
                                            p, p, p, p, p, p, p,
                                            p, ll, i, i, i, i, i, i, p]
        bwd.cond_chain_bwd_bf16.restype = i
        _lib = libs
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


def _f32(*xs):
    """The operands in float32 (a no-op for float32 ones)."""
    return [None if x is None else x.float() for x in xs]


def _round_as(x, dtype):
    """x rounded to ``dtype`` and held in float32 again (a no-op in f32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def cond_chain_plain(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """The chain in plain PyTorch: conv1d over ``exc``, bias and edge fixes,
    leaky_relu, then the n per-block convs as one grouped conv1d. Under
    autograd its leaky_relu takes the slope 1 at h = 0, as K2 and the JAX
    package do.

    ``hbias`` is (B, n*Cc) or (n*Cc,); ``edge0``/``edge_t`` (B, n*Cc) are
    subtracted at rows 0 and T-1 when given. bfloat16 operands are computed
    in f32 from their values and rounded where K1-bf16 rounds: lrelu(h) once,
    the output once (bf16).
    """
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    dt = exc.dtype
    exc, w0, hbias, w1, b1, edge0, edge_t = _f32(exc, w0, hbias, w1, b1, edge0, edge_t)
    a = leaky_relu(_h_plain(exc, w0, hbias, edge0, edge_t, n, cc), LEAKY_RELU_SLOPE)
    out = F.conv1d(_round_as(a, dt), w1.permute(2, 1, 0), b1, padding=1, groups=n)
    return out.transpose(1, 2).contiguous().to(dt)


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

    bfloat16 operands are computed in f32 from their values and rounded where
    K2-bf16 rounds: lrelu(h) (for dW1) and dh once each, dexc once, and every
    weight and bias gradient summed in f32 and rounded once; each gradient
    comes back in its operand's dtype.
    """
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    dt = exc.dtype
    exc, w0, hbias, w1, g, edge0, edge_t = _f32(exc, w0, hbias, w1, g, edge0, edge_t)
    h = _h_plain(exc, w0, hbias, edge0, edge_t, n, cc)          # (B, n*Cc, T)
    a = _round_as(F.leaky_relu(h, LEAKY_RELU_SLOPE), dt)
    gt = g.transpose(1, 2)                                       # (B, n*2C, T)
    da = F.conv_transpose1d(gt, w1.permute(2, 1, 0), padding=1, groups=n)
    dh = _round_as(torch.where(h >= 0, da, LEAKY_RELU_SLOPE * da), dt)
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
    return {k: v.to(dt) for k, v in out.items()}


_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(name, x, device, dtype):
    if x.device != device:
        raise ValueError(f"cond chain: {name} is on {x.device}, exc on {device}")
    if dtype not in _DTYPES:
        raise TypeError(f"cond chain kernels take float32 or bfloat16, exc is {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"cond chain kernels take operands of one dtype: {name} is "
                        f"{x.dtype}, exc {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cond chain kernel takes contiguous tensors; {name} is not")


def _check_operands(exc, w0, hbias, w1, b1, edge0, edge_t):
    """Shapes, device, dtype (all float32 or all bfloat16) and contiguity the
    kernels take; (B, T, E, n, Cc, 2C). Any widths: the wrapper pads them to
    what each kernel takes. ``b1`` may be None (the backward does not read
    it)."""
    b, t, e, n, cc, two_c = _dims(exc, w0, w1)
    dev = exc.device
    ops = {"exc": exc, "w0": w0, "hbias": hbias, "w1": w1}
    if b1 is not None:
        ops.update(b1=b1)
    if edge0 is not None:
        ops.update(edge0=edge0, edge_t=edge_t)
    for name, x in ops.items():
        _check_cuda(name, x, dev, exc.dtype)
    if hbias.shape not in ((b, n * cc), (n * cc,)) or (
            b1 is not None and b1.shape != (n * two_c,)):
        raise ValueError(f"cond chain bias shapes {tuple(hbias.shape)} / "
                         f"{None if b1 is None else tuple(b1.shape)}")
    if edge0 is not None and (edge0.shape != (b, n * cc) or edge_t.shape != (b, n * cc)):
        raise ValueError("cond chain edges must be (B, n*Cc)")
    return b, t, e, n, cc, two_c


# The widths each kernel takes, as the multiples of (Cc, 2C) it needs: K2's
# and K2-bf16's tensor maps copy rows in 16-byte pieces, K1 stores output
# columns in pairs. Other widths are padded with
# zero channels per block (_pad_widths) and the results cut back
# (_cut_grads, _cut_blocks).
_GRAIN = {"fwd": (1, 2), "bwd": (4, 4), "fwd_bf16": (4, 4), "bwd_bf16": (4, 8)}


def _padded_e(kind: str, e: int) -> int:
    """E as the kernel ``kind`` takes it. K1-bf16 stages exc by TMA in rows
    of 8 channels up to E = 16, else of 64 (a group of 8 k, or a chunk of 64,
    of cond_0's product is then one tap's channels): exc and W0 are padded
    with zero channels (_pad_exc; exact: a zero channel adds nothing to h)."""
    if kind != "fwd_bf16":
        return e
    return _round_up(e, 8 if e <= 16 else 64)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _padded_widths(kind: str, cc: int, two_c: int) -> tuple[int, int]:
    """(Cc, 2C) rounded up to what the kernel ``kind`` (a key of _GRAIN) takes."""
    gc, g2 = _GRAIN[kind]
    return _round_up(cc, gc), _round_up(two_c, g2)


def _pad_blocks(x, n, two_c, width):
    """x (..., n*2C) with each block's 2C columns padded to ``width`` with
    zeros: (..., n*width), contiguous."""
    out = x.new_zeros((*x.shape[:-1], n, width))
    out[..., :two_c] = x.reshape(*x.shape[:-1], n, two_c)
    return out.reshape(*x.shape[:-1], n * width)


def _cut_blocks(x, n, width, keep):
    """x (..., n*width) with each block's first ``keep`` columns:
    (..., n*keep), contiguous."""
    return x.reshape(*x.shape[:-1], n, width)[..., :keep].reshape(*x.shape[:-1], n * keep)


_CC_KEYS = ("w0", "hbias", "edge0", "edge_t")  # operands with n*Cc columns


def _pad_exc(exc, w0, e_to):
    """exc (B, T, E) and w0 (3, E, n*Cc) with E padded to ``e_to`` zero
    channels."""
    e = exc.shape[-1]
    if e_to == e:
        return exc, w0
    return F.pad(exc, (0, e_to - e)), F.pad(w0, (0, 0, 0, e_to - e))


def _pad_widths(ops: dict, n, cc, two_c, cc_to, two_c_to) -> dict:
    """The chain's operands (any of ``w0``, ``hbias``, ``edge0``,
    ``edge_t``, ``w1``, ``b1``, ``g``) with each block's Cc channels padded to
    ``cc_to`` and its 2C output columns to ``two_c_to``, with zeros."""
    out = dict(ops)
    for k, v in ops.items():
        if v is None:
            continue
        if k in _CC_KEYS and cc_to != cc:
            out[k] = _pad_blocks(v, n, cc, cc_to)
        elif k in ("b1", "g") and two_c_to != two_c:
            out[k] = _pad_blocks(v, n, two_c, two_c_to)
        elif k == "w1":
            if two_c_to != two_c:
                v = _pad_blocks(v, n, two_c, two_c_to)
            out[k] = F.pad(v, (0, 0, 0, cc_to - cc)) if cc_to != cc else v
    return out


def _cut_grads(grads: dict, n, cc, two_c, cc_from, two_c_from) -> dict:
    """The backward's gradients at padded widths (``cc_from``,
    ``two_c_from``) cut back to the operands' (Cc, 2C)."""
    out = dict(grads)
    for k in _CC_KEYS:
        if k in out and cc_from != cc:
            out[k] = _cut_blocks(out[k], n, cc_from, cc)
    w1 = out["w1"]
    if two_c_from != two_c:
        w1 = _cut_blocks(w1, n, two_c_from, two_c)
        out["b1"] = _cut_blocks(out["b1"], n, two_c_from, two_c)
    out["w1"] = w1[:, :cc].contiguous() if cc_from != cc else w1
    return out


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _error(lib, err):
    return lib.cond_chain_error_string(err).decode()


def _launch(exc, w0, hbias, w1, b1, edge0, edge_t):
    """K1 (float32 operands) or K1-bf16 (bfloat16): the forward kernel,
    (B, T, n*2C) in the operands' dtype, at any widths (padded to what the
    kernel takes, the output cut back)."""
    b, t, e, n, cc, two_c = _check_operands(exc, w0, hbias, w1, b1, edge0, edge_t)
    kind = "fwd_bf16" if exc.dtype == torch.bfloat16 else "fwd"
    if _padded_e(kind, e) != e:
        exc, w0 = _pad_exc(exc, w0, _padded_e(kind, e))
        e = exc.shape[-1]
    if kind == "fwd_bf16":
        exc = _aligned16(exc)  # its tensor map
    cc_p, two_c_p = _padded_widths(kind, cc, two_c)
    if (cc_p, two_c_p) == (cc, two_c):
        return _launch_fwd(kind, exc, w0, hbias, w1, b1, edge0, edge_t, b, t, e, n, cc, two_c)
    ops = _pad_widths(dict(w0=w0, hbias=hbias, w1=w1, b1=b1, edge0=edge0, edge_t=edge_t),
                      n, cc, two_c, cc_p, two_c_p)
    out = _launch_fwd(kind, exc, **ops, b=b, t=t, e=e, n=n, cc=cc_p, two_c=two_c_p)
    return _cut_blocks(out, n, two_c_p, two_c) if two_c_p != two_c else out


def _launch_fwd(kind, exc, w0, hbias, w1, b1, edge0, edge_t, b, t, e, n, cc, two_c):
    """One launch of K1 or K1-bf16 at widths it takes, with the workspace
    for the images of W0 and W1 it makes at each launch."""
    global launches, launches_bf16
    fwd = _library()[kind]
    out = torch.empty((b, t, n * two_c), device=exc.device, dtype=exc.dtype)
    args = (exc.data_ptr(), w0.data_ptr(), hbias.data_ptr(), n * cc if hbias.dim() == 2 else 0,
            edge0.data_ptr() if edge0 is not None else None,
            edge_t.data_ptr() if edge_t is not None else None,
            w1.data_ptr(), b1.data_ptr(), out.data_ptr())
    if kind == "fwd_bf16":
        nbytes = fwd.cond_chain_fwd_bf16_workspace(b, e, n, cc, two_c)
        launch = fwd.cond_chain_fwd_bf16
    else:
        nbytes = fwd.cond_chain_fwd_f32_workspace(b, e, n, cc, two_c,
                                                  int(hbias.dim() == 2 or edge0 is not None))
        launch = fwd.cond_chain_fwd_f32
    ws = torch.empty(int(nbytes), device=exc.device, dtype=torch.uint8)
    err = launch(*args, ws.data_ptr(), ws.numel(), b, t, e, n, cc, two_c, _stream(exc.device))
    if err:
        raise RuntimeError("cond chain kernel launch failed: " + _error(fwd, err))
    if kind == "fwd_bf16":
        launches_bf16 += 1
    else:
        launches += 1
    return out


def _launch_bwd(exc, w0, hbias, w1, g, edge0, edge_t):
    """K2 (float32 operands) or K2-bf16 (bfloat16): the backward kernels, the
    same dict as :func:`cond_chain_bwd_plain`, at any widths (padded to what
    the kernels take, the gradients cut back)."""
    b, t, e, n, cc, two_c = _check_operands(exc, w0, hbias, w1, None, edge0, edge_t)
    _check_cuda("g", g, exc.device, exc.dtype)
    if g.shape != (b, t, n * two_c):
        raise ValueError(f"cond chain cotangent {tuple(g.shape)} is not {(b, t, n * two_c)}")
    bf16 = exc.dtype == torch.bfloat16
    run = _launch_bwd_bf16 if bf16 else _launch_bwd_f32
    cc_p, two_c_p = _padded_widths("bwd_bf16" if bf16 else "bwd", cc, two_c)
    ops = dict(w0=w0, hbias=hbias, w1=w1, g=g, edge0=edge0, edge_t=edge_t)
    if (cc_p, two_c_p) == (cc, two_c):
        return run(exc, **ops, b=b, t=t, e=e, n=n, cc=cc, two_c=two_c)
    ops = _pad_widths(ops, n, cc, two_c, cc_p, two_c_p)
    grads = run(exc, **ops, b=b, t=t, e=e, n=n, cc=cc_p, two_c=two_c_p)
    return _cut_grads(grads, n, cc, two_c, cc_p, two_c_p)


def _launch_bwd_f32(exc, w0, hbias, w1, g, edge0, edge_t, b, t, e, n, cc, two_c):
    """K2 on checked f32 operands at widths it takes: the gradients."""
    global bwd_launches
    g = _aligned16(g)  # the tensor maps of g
    libs = _library()
    fwd, bwd = libs["fwd"], libs["bwd"]
    dev = exc.device
    per_row = int(hbias.dim() == 2 or edge0 is not None)
    ws = torch.empty(int(bwd.cond_chain_bwd_workspace(b, t, e, n, cc, two_c, per_row)),
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
        w1.data_ptr(), g.data_ptr(),
        out["exc"].data_ptr(), out["w0"].data_ptr(), out["hbias"].data_ptr(),
        out["edge0"].data_ptr() if edge0 is not None else None,
        out["edge_t"].data_ptr() if edge0 is not None else None,
        out["w1"].data_ptr(), out["b1"].data_ptr(),
        ws.data_ptr(), ws.numel(), b, t, e, n, cc, two_c, _stream(dev))
    if err:
        raise RuntimeError("cond chain backward kernel launch failed: " + _error(fwd, err))
    bwd_launches += 1
    return out


def _aligned16(x):
    """x, or a copy of it at a 16-byte aligned address."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_bwd_bf16(exc, w0, hbias, w1, g, edge0, edge_t, b, t, e, n, cc, two_c):
    """K2-bf16 on checked bf16 operands at widths it takes: the gradients in
    bf16."""
    global bwd_launches_bf16
    w1, g = _aligned16(w1), _aligned16(g)
    libs = _library()
    fwd, bwd = libs["fwd_bf16"], libs["bwd_bf16"]
    dev = exc.device
    ws = torch.empty(int(bwd.cond_chain_bwd_bf16_workspace(b, t, e, n, cc, two_c)),
                     device=dev, dtype=torch.uint8)
    out = dict(exc=torch.empty_like(exc), w0=torch.empty_like(w0),
               hbias=torch.empty_like(hbias), w1=torch.empty_like(w1),
               b1=torch.empty(n * two_c, device=dev, dtype=torch.bfloat16))
    if edge0 is not None:
        out.update(edge0=torch.empty_like(edge0), edge_t=torch.empty_like(edge_t))
    err = bwd.cond_chain_bwd_bf16(
        exc.data_ptr(), w0.data_ptr(), hbias.data_ptr(),
        n * cc if hbias.dim() == 2 else 0,
        edge0.data_ptr() if edge0 is not None else None,
        edge_t.data_ptr() if edge_t is not None else None,
        w1.data_ptr(), g.data_ptr(),
        out["exc"].data_ptr(), out["w0"].data_ptr(), out["hbias"].data_ptr(),
        out["edge0"].data_ptr() if edge0 is not None else None,
        out["edge_t"].data_ptr() if edge0 is not None else None,
        out["w1"].data_ptr(), out["b1"].data_ptr(),
        ws.data_ptr(), ws.numel(), b, t, e, n, cc, two_c, _stream(dev))
    if err:
        raise RuntimeError("cond chain bf16 backward kernel launch failed: " + _error(fwd, err))
    bwd_launches_bf16 += 1
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
    tensors (their bf16 instances for bfloat16 operands); the plain versions
    on CPU tensors."""

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
