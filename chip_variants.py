"""Versions of K2 (f32) or K2-bf16 timed against each other on the card.

    python3 chip_variants.py [--bf16] DIR [DIR ...]

Each DIR holds a version of the backward's sources, the files of
``td_vc_gan_tpu_torch/csrc`` side by side with this tree's C interface (an
earlier commit's, e.g. ``git archive <commit> td_vc_gan_tpu_torch/csrc``
unpacked flat, or a copy with a change to try). Each version's
``cond_chain_bwd.cu`` (``cond_chain_bwd_bf16.cu`` with --bf16) is built
with the package's nvcc flags (all builds at once) and its ptxas lines for
the data kernel (with --bf16 every K2-bf16 kernel) printed (registers,
spills, any wgmma serialization); at the f32 train step's 8 chain shapes
(with --bf16 the batch-64 step's) every version is held to the plain
version (f32: 1e-4 of max|ref|; bf16: one bf16 ulp) and to itself in a
second run (bit for bit), then timed: the whole call with CUDA events, the
versions alternated for 5 rounds, and its kernels' device time
(torch.profiler). Prints the backward's median per step (8 calls), its
rounds, and per step the data kernel and reduce (with --bf16 the data and
weight-grad kernels) for each version, with the card's name and power
limit. Needs a CUDA card; imports nothing of JAX.
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
    lines for the data kernel (K2-bf16: every kernel)."""
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
            if bf16 or "k2_data" in x or ("C75" in x and "k2b" not in x and "k1" not in x)),
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
        libs[name] = lib
    return libs


def main(dirs: list[Path], bf16: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cfg = cs.Config()
    dtype, bsz = (torch.bfloat16, cs.B64) if bf16 else (torch.float32, cs.B)
    kinds = (("data", "k2b_data"), ("w1", "k2b_w1")) if bf16 else (("data", "k2_data"),
                                                                  ("reduce", "k2_reduce"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(dirs, Path(tmp), bf16)
        tot = {n: [0.0] * cs.AB_ROUNDS for n in libs}
        data = {n: 0.0 for n in libs}
        red = {n: 0.0 for n in libs}
        for b in (2 * bsz, bsz):
            for k, (t, c) in enumerate(cs.stage_shapes(cs.SEG, cfg)):
                split, _, _, _ = cs.chain_inputs(b, t, c, cfg, seed=700 + k, exact_h=True,
                                                 dtype=dtype)
                g = cs.cotangent(split, seed=750 + k).to(dtype)
                args = {key: v for key, v in split.items() if key != "b1"}
                want = cs.cc_mod.cond_chain_bwd_plain(g=g, **args)
                for name, lib in libs.items():
                    got, again = cs.old_k2(lib, args, g), cs.old_k2(lib, args, g)
                    for key in want:
                        if bf16:
                            cs.ulp_parity(f"{name} B={b} T={t} d{key}", got[key], want[key])
                        else:
                            cs.ab_f32_agree(f"{name} B={b} T={t} d{key}", got[key], want[key])
                        if not torch.equal(got[key], again[key]):
                            raise AssertionError(f"{name}: d{key} differs run to run")
                    del got, again
                for r in range(cs.AB_ROUNDS):
                    for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                        tot[name][r] += cs.cuda_ms(lambda: cs.old_k2(libs[name], args, g),
                                                   iters=2, warmup=1)
                line = []
                for name, lib in libs.items():
                    part = cs.kernel_breakdown(lambda: cs.old_k2(lib, args, g))
                    dk = sum(v[0] for key, v in part.items() if key.startswith(kinds[0][1]))
                    rk = sum(v[0] for key, v in part.items() if key.startswith(kinds[1][1]))
                    data[name] += dk
                    red[name] += rk
                    line.append(f"{name} {kinds[0][0]} {dk:.3f} {kinds[1][0]} {rk:.3f}")
                print(f"B={b} T={t} C={c}: " + ", ".join(line) + f" ms [{card}]", flush=True)
                del split, g, args, want
                torch.cuda.empty_cache()
    for name in libs:
        print(f"{name}: {'K2-bf16' if bf16 else 'K2'} per step median "
              f"{np.median(tot[name]):.3f} ms (rounds "
              f"{', '.join(f'{x:.3f}' for x in sorted(tot[name]))}); {kinds[0][0]} kernel "
              f"{data[name]:.3f} ms, {kinds[1][0]} {red[name]:.3f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    use_bf16 = "--bf16" in args
    args = [x for x in args if x != "--bf16"]
    if not args:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    cs.adopt_orphans()
    try:
        rc = main([Path(d) for d in args], use_bf16)
    finally:
        cs.end_children()
    sys.exit(rc)
