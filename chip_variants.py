"""Versions of K2 (f32) or K2-bf16 timed against each other on the card.

    python3 chip_variants.py [--bf16 | --wide] DIR [DIR ...]

Each DIR holds a version of the backward's sources, the files of
``td_vc_gan_tpu_torch/csrc`` side by side with this tree's C interface (an
earlier commit's, e.g. ``git archive <commit> td_vc_gan_tpu_torch/csrc``
unpacked flat, or a copy with a change to try). Each version's
``cond_chain_bwd.cu`` (``cond_chain_bwd_bf16.cu`` with --bf16) is built
with the package's nvcc flags (all builds at once) and its ptxas lines for
the data and weight-grad kernels and the reduce (with --bf16 every K2-bf16
kernel) printed (registers,
spills, any wgmma serialization); at the f32 train step's 8 chain shapes
(with --bf16 the batch-64 step's) every version is held to the plain
version (f32: 1e-4 of max|ref|; bf16: one bf16 ulp) and to itself in a
second run (bit for bit), then timed: the whole call with CUDA events, the
versions alternated for 5 rounds, and its kernels' device time (the events
each library records between its launches). Prints the backward's median
per step (8 calls), its rounds, and per step the data kernel, the
weight-grad kernel and (f32) the reduce for each version, with the card's
name and power limit. --wide (f32) then does the same at the concat-form
shapes of ``chip_smoke.wide_shapes`` (the options' bottleneck, n = 1, and
E = Cc = 600; past E = 9 K2 is five launches), each shape's times printed
alone. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def build(dirs: list[Path], out: Path, bf16: bool = False) -> dict:
    """{name: ctypes library} of each directory's cond_chain_bwd.cu (or
    cond_chain_bwd_bf16.cu), built in parallel; prints each build's ptxas
    lines for the data and weight-grad kernels and the reduce (K2-bf16:
    every kernel)."""
    src = "cond_chain_bwd_bf16.cu" if bf16 else "cond_chain_bwd.cu"
    procs = {d.name: (out / f"{d.name}.so",
                      subprocess.Popen([cs.cc_mod._nvcc(), *cs.cc_mod.NVCC_FLAGS, "-o",
                                        str(out / f"{d.name}.so"), str(d / src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for d in dirs}
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        print(f"{name}: " + " | ".join(
            x for x in cs.ptxas_summary(log)
            if bf16 or "k2_data" in x or "k2_w1" in x or "k2_reduce" in x
            or ("C75" in x and "k2b" not in x and "k1" not in x)),
            flush=True)
        lib = ctypes.CDLL(str(so))
        if bf16:
            lib.cond_chain_bwd_bf16_workspace.argtypes = [i] * 6
            lib.cond_chain_bwd_bf16_workspace.restype = ll
            lib.cond_chain_bwd_bf16.argtypes = [p] * 3 + [ll] + [p] * 12 + [ll] + [i] * 6 + [p]
            lib.cond_chain_bwd_bf16.restype = i
        else:
            lib.cond_chain_bwd_workspace.argtypes = [i] * 7
            lib.cond_chain_bwd_workspace.restype = ll
            lib.cond_chain_bwd_f32.argtypes = [p] * 3 + [ll] + [p] * 12 + [ll] + [i] * 6 + [p]
            lib.cond_chain_bwd_f32.restype = i
        prefix = "cond_chain_bwd_bf16" if bf16 else "cond_chain_bwd"
        lib.kernel_ms = getattr(lib, f"{prefix}_kernel_ms")
        lib.kernel_ms.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.launched = (lambda: 4) if bf16 else lib.cond_chain_bwd_launched
        getattr(lib, f"{prefix}_time_kernels")(1)
        libs[name] = lib
    return libs


def kernel_ms(lib, fn) -> list[float]:
    """The device ms of each launch of one call of ``fn`` (a warm call of
    ``lib``'s backward), from the events the library records between them:
    at the step's E = 8 the images, the data kernel, the weight-grad kernel
    and the reduce (past E = 9 ``k2_xdh_kernel`` before the reduce)."""
    fn()
    torch.cuda.synchronize()
    ms = (ctypes.c_float * 6)()
    if lib.kernel_ms(ms):
        raise RuntimeError("the kernels' events could not be read")
    return list(ms[:lib.launched()])


def compare(libs: dict, label: str, args: dict, g, bf16: bool, kinds, card: str) -> tuple:
    """Every version held to the plain version and to itself in a second run
    at one shape, then timed alternated for AB_ROUNDS rounds; prints the
    kernels' times; returns ({name: [ms a round]}, {name: [ms a kind]})."""
    want = cs.cc_mod.cond_chain_bwd_plain(g=g, **args)
    for name, lib in libs.items():
        got, again = cs.old_k2(lib, args, g), cs.old_k2(lib, args, g)
        for key in want:
            if bf16:
                cs.ulp_parity(f"{name} {label} d{key}", got[key], want[key])
            else:
                cs.ab_f32_agree(f"{name} {label} d{key}", got[key], want[key])
            if not torch.equal(got[key], again[key]):
                raise AssertionError(f"{name}: d{key} differs run to run")
        del got, again
    rounds = {name: [] for name in libs}
    for r in range(cs.AB_ROUNDS):
        for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
            rounds[name].append(cs.cuda_ms(lambda: cs.old_k2(libs[name], args, g), iters=2,
                                           warmup=1))
    kind_ms, line = {}, []
    for name, lib in libs.items():
        times = kernel_ms(lib, lambda: cs.old_k2(lib, args, g))
        kind_ms[name] = [times[k] for _, k in kinds]
        line.append(f"{name} " + " ".join(
            f"{lab} {x:.3f}" for (lab, _), x in zip(kinds, kind_ms[name])))
    print(f"{label}: " + ", ".join(line) + f" ms [{card}]", flush=True)
    return rounds, kind_ms


def main(dirs: list[Path], bf16: bool = False, wide: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cfg = cs.Config()
    dtype, bsz = (torch.bfloat16, cs.B64) if bf16 else (torch.float32, cs.B)
    # (label, launch index) of the kernels printed: the data and weight-grad
    # kernels and, for K2 (f32), the reduce (the last launch)
    kinds = ((("data", 1), ("w1", 2)) if bf16 else (("data", 1), ("w1", 2), ("reduce", -1)))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(dirs, Path(tmp), bf16)
        tot = {n: [0.0] * cs.AB_ROUNDS for n in libs}
        per_kind = {n: [0.0] * len(kinds) for n in libs}
        for b in (2 * bsz, bsz):
            for k, (t, c) in enumerate(cs.stage_shapes(cs.SEG, cfg)):
                split, _, _, _ = cs.chain_inputs(b, t, c, cfg, seed=700 + k, exact_h=True,
                                                 dtype=dtype)
                g = cs.cotangent(split, seed=750 + k).to(dtype)
                args = {key: v for key, v in split.items() if key != "b1"}
                rounds, kind_ms = compare(libs, f"B={b} T={t} C={c}", args, g, bf16, kinds, card)
                for name in libs:
                    tot[name] = [x + y for x, y in zip(tot[name], rounds[name])]
                    per_kind[name] = [x + y for x, y in zip(per_kind[name], kind_ms[name])]
                del split, g, args
                torch.cuda.empty_cache()
        for name in libs:
            print(f"{name}: {'K2-bf16' if bf16 else 'K2'} per step median "
                  f"{np.median(tot[name]):.3f} ms (rounds "
                  f"{', '.join(f'{x:.3f}' for x in sorted(tot[name]))}); by kernel "
                  + ", ".join(f"{lab} {x:.3f} ms" for (lab, _), x in zip(kinds, per_kind[name]))
                  + f" [{card}]", flush=True)
        for k, (label, b, t, cc, two_c, n) in enumerate(cs.wide_shapes(cfg) if wide else ()):
            ops = cs.wide_operands(cfg, b, t, cc, two_c, n, 3300 + k, torch.float32)
            args = dict(exc=ops["c"], w0=ops["w0"], hbias=ops["b0"], w1=ops["w1"], edge0=None,
                        edge_t=None)
            rounds, _ = compare(libs, label, args, ops["g"], bf16, kinds, card)
            print(f"{label}: K2 median " + ", ".join(
                f"{name} {np.median(rounds[name]):.4f}" for name in libs) + f" ms [{card}]",
                flush=True)
            del ops, args
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    use_bf16, use_wide = "--bf16" in args, "--wide" in args
    args = [x for x in args if x not in ("--bf16", "--wide")]
    if not args or (use_bf16 and use_wide):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    cs.adopt_orphans()
    try:
        rc = main([Path(d) for d in args], use_bf16, use_wide)
    finally:
        cs.end_children()
    sys.exit(rc)
