"""Versions of K2 (f32) timed against each other on the card.

    python3 chip_variants.py DIR [DIR ...]

Each DIR holds a version of the f32 backward's sources, the files of
``td_vc_gan_tpu_torch/csrc`` side by side with this tree's C interface (an
earlier commit's, e.g. ``git archive <commit> td_vc_gan_tpu_torch/csrc``
unpacked flat, or a copy with a change to try). Each version's
``cond_chain_bwd.cu`` is built with the package's nvcc flags (all builds at
once) and its ptxas lines for the data kernel printed (registers, spills,
any wgmma serialization); at the f32 train step's 8 chain shapes every
version is held to the plain version (1e-4 of max|ref|) and to itself in a
second run (bit for bit), then timed: the whole call with CUDA events, the
versions alternated for 5 rounds, and its data kernel's and reduce's device
time (torch.profiler). Prints K2's median per step (8 calls), its rounds,
and the data kernel and reduce per step for each version, with the card's
name and power limit. Needs a CUDA card; imports nothing of JAX.
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


def build(dirs: list[Path], out: Path) -> dict:
    """{name: ctypes library} of each directory's cond_chain_bwd.cu, built
    in parallel; prints each build's data-kernel ptxas lines."""
    procs = {d.name: (out / f"{d.name}.so",
                      subprocess.Popen([cs.cc_mod._nvcc(), *cs.cc_mod.NVCC_FLAGS, "-o",
                                        str(out / f"{d.name}.so"), str(d / "cond_chain_bwd.cu")],
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
            if "k2_data" in x or ("C75" in x and "k2b" not in x and "k1" not in x)), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.cond_chain_bwd_workspace.argtypes = [i] * 7
        lib.cond_chain_bwd_workspace.restype = ll
        lib.cond_chain_bwd_f32.argtypes = [p] * 3 + [ll] + [p] * 12 + [ll] + [i] * 6 + [p]
        lib.cond_chain_bwd_f32.restype = i
        libs[name] = lib
    return libs


def main(dirs: list[Path]) -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cfg = cs.Config()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(dirs, Path(tmp))
        tot = {n: [0.0] * cs.AB_ROUNDS for n in libs}
        data = {n: 0.0 for n in libs}
        red = {n: 0.0 for n in libs}
        for b in (2 * cs.B, cs.B):
            for k, (t, c) in enumerate(cs.stage_shapes(cs.SEG, cfg)):
                split, _, _, _ = cs.chain_inputs(b, t, c, cfg, seed=700 + k, exact_h=True)
                g = cs.cotangent(split, seed=750 + k)
                args = {key: v for key, v in split.items() if key != "b1"}
                want = cs.cc_mod.cond_chain_bwd_plain(g=g, **args)
                for name, lib in libs.items():
                    got, again = cs.old_k2(lib, args, g), cs.old_k2(lib, args, g)
                    for key in want:
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
                    dk = sum(v[0] for key, v in part.items() if key.startswith("k2_data"))
                    rk = sum(v[0] for key, v in part.items() if key.startswith("k2_reduce"))
                    data[name] += dk
                    red[name] += rk
                    line.append(f"{name} data {dk:.3f} reduce {rk:.3f}")
                print(f"B={b} T={t} C={c}: " + ", ".join(line) + f" ms [{card}]", flush=True)
                del split, g, args, want
                torch.cuda.empty_cache()
    for name in libs:
        print(f"{name}: K2 per step median {np.median(tot[name]):.3f} ms (rounds "
              f"{', '.join(f'{x:.3f}' for x in sorted(tot[name]))}); data kernel "
              f"{data[name]:.3f} ms, reduce {red[name]:.3f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    cs.adopt_orphans()
    try:
        rc = main([Path(d) for d in sys.argv[1:]])
    finally:
        cs.end_children()
    sys.exit(rc)
