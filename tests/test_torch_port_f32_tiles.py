"""The tiling of the Hopper f32 cond-chain kernels, emulated in numpy, and the
wrapper's width repair.

K1 (``csrc/cond_chain.cu``) and K2's kernels (``csrc/cond_chain_bwd.cu``) run
on the card only. Their index arithmetic, their 3xTF32 rounding and the
order of their products are emulated here step by step as the kernels take
them (``csrc/cond_chain_f32.cuh`` describes the CTA) and held to the plain
versions (``cond_chain_plain``, ``cond_chain_bwd_plain``) within
``testing.PARITY_RTOL`` of max|ref|, as ``chip_smoke.py`` holds the kernels
on the card:

- a CTA owns 124 time rows; its two consumer warpgroups hold 64 rows of h
  each, from t0 + 62 w - 1, overlapping by two rows; the last tile is ragged;
- every operand a product reads is split into hi = tf32(x) and
  lo = tf32(x - hi) (``cvt.rna``: nearest, ties away from zero), and every
  product of a k-slice of 8 is taken as lo.hi + hi.lo + hi.hi into the f32
  accumulator, in that order;
- cond_0 is one product, h = X @ Wh with X = [exc taps | 1 | -[u == 0] |
  -[u == T-1]] and Wh = [W0; hbias; edge0; edge_t], K = 3E + 3 in k-slices
  of 8, per pass of 136 columns of h;
- K1: lrelu(h) of a pass (zero outside [0, T) and past Cc) is the A of P;
  at E <= 9, one pass and W <= 64 output columns a chunk the three taps are
  P's N, P_j = A @ W1_i[j], and out = ((b1 + P_0[r]) + P_1[r + 1]) +
  P_2[r + 2] from P staged in shared memory; else out = b1 + sum_j A(rows
  j ..) @ W1_i[j], the pass's k-slices, each with its three taps, summed over
  the passes; W1's image read back through the descriptors (at W = 32 each
  slice's k order permuted, so that A's lo is h's accumulator as it lies);
- K2's data kernel: a CTA per (run of tiles of one batch row, block, pass),
  the runs as make_plan chooses them (``k2_plan``); da from g's rows
  62 w + q + 2 - j of the tile's 128-row stage; dh = lrelu'(h) da (past
  E = 9 its own rows to the dh scratch); dexc as P = dh @ [W0_i[0]^T |
  W0_i[1]^T | W0_i[2]^T] with dh's neighbours (2 tig, 2 tig + 1) as the A
  fragment's columns (tig, tig + 4) (the image's K order permuted to match),
  then dexc[t] = (P_0[t+1] + P_1[t]) + P_2[t-1] as each block's and pass's
  part, the parts summed in order; at E <= 9 X^T dh per tile and warpgroup
  from dh and X (its halo rows zeroed), added into each warpgroup's sums
  tile by tile, the two warpgroups' sums added at the run's end: a partial
  per (batch row, run); db1 per tile;
- k2_w1_kernel: the items (tile of (block, pass, 64 or 32 output
  channels), 64-row unit) in equal runs over the card's 132 SMs
  (``w1_plan``, ``w1_segments``); per item lrelu(h) recomputed with the
  data kernel's bits (checked) from X's K-major image (read back through
  h's descriptors), written split into a K-major image (element (c, s) at
  (c / 8) 2048 + (s / 4) 128 + (c % 8) 16 + (s % 4) 4 bytes) and read back
  through the products' descriptors; A = g^T read from the raw TMA stage of
  g with the rows shifted by the tap, the three taps stacked as M rows
  (tap, o), 64 a product warpgroup, N = all 136 columns; the accumulators'
  runs of at most 16 units of a segment added in order into the segment's
  partial, one a (tile, CTA); the reduce sums more than 256 partials of an
  output of a small job by a warp (``reduce_sum``), its threads laid out
  over the jobs as ``reduce_threads`` has them;
- k2_xdh_kernel (past E = 9 only): X = [exc taps | 1 | -[t == 0] |
  -[t == T-1]] built per step of 64 rows into its K-major image, A = dh^T
  from the raw stage of the dh scratch, X^T dh per (batch row, part); the
  reduce sums every kind of partial in order.

Numpy and torch's CPU ops only, no JAX compile.
"""

import sys

import numpy as np
import pytest
import torch

from td_vc_gan_tpu_torch import testing
from td_vc_gan_tpu_torch.ops.cuda import cond_chain

torch.set_num_threads(1)

TILE, OWN, ROWS, PASS = 124, 62, 64, 136
SLOPE = np.float32(0.2)


def tf32(x):
    """x rounded to TF32, nearest, ties away from zero (cvt.rna.tf32.f32)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def add3(acc, a, b):
    """acc += a @ b as the kernels take a k-slice: lo.hi + hi.lo + hi.hi,
    each product added in turn (batched over leading axes)."""
    ah, al = split(a)
    bh, bl = split(b)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        acc += np.matmul(x, y, dtype=np.float32)
    return acc


def np32(d):
    return {k: (None if v is None else v.numpy()) for k, v in d.items()}


def chain_dims(exc, w0, w1):
    b, t, e = exc.shape
    cc = w1.shape[1]
    n = w0.shape[2] // cc
    return b, t, e, n, cc, w1.shape[2] // n


def x_rows(exc, u):
    """X (B, len(u), K8) at h rows u: exc's three taps, 1, -[u == 0],
    -[u == T-1], zeros to a multiple of 8."""
    b, t, e = exc.shape
    k = 3 * e + 3
    x = np.zeros((b, len(u), -(-k // 8) * 8), np.float32)
    for j in range(3):
        tt = u + j - 1
        ok = (tt >= 0) & (tt < t)
        x[:, ok, j * e:(j + 1) * e] = exc[:, tt[ok]]
    x[:, :, 3 * e] = 1
    x[:, :, 3 * e + 1] = -(u == 0).astype(np.float32)
    x[:, :, 3 * e + 2] = -(u == t - 1).astype(np.float32)
    return x


def wh_block(w0, hbias, edge0, edge_t, i, cc, b, k8):
    """Wh of block i (B, K8, Cc): W0's three taps, hbias, the edges, zeros."""
    e = w0.shape[1]
    cols = slice(i * cc, (i + 1) * cc)
    wh = np.zeros((b, k8, cc), np.float32)
    wh[:, :3 * e] = w0[:, :, cols].reshape(3 * e, cc)
    wh[:, 3 * e] = (hbias if hbias.ndim == 2 else hbias[None])[:, cols]
    if edge0 is not None:
        wh[:, 3 * e + 1] = edge0[:, cols]
        wh[:, 3 * e + 2] = edge_t[:, cols]
    return wh


def h_at(exc, w0, hbias, edge0, edge_t, i, p, cc, u):
    """h of block i's pass p at the rows u (any shape, rows of 64 last),
    before leaky_relu, as h_pass takes it: (B, *u.shape, 136)."""
    b = exc.shape[0]
    x = x_rows(exc, u.reshape(-1)).reshape(b, *u.shape, -1)
    wh = wh_block(w0, hbias, edge0, edge_t, i, cc, b, x.shape[-1])
    cols = np.zeros((b, x.shape[-1], PASS), np.float32)
    width = min(PASS, cc - PASS * p)
    cols[..., :width] = wh[..., PASS * p:PASS * p + width]
    cols = cols.reshape(b, *([1] * (u.ndim - 1)), x.shape[-1], PASS)
    acc = np.zeros((b, *u.shape, PASS), np.float32)
    for s in range(x.shape[-1] // 8):
        add3(acc, x[..., 8 * s:8 * s + 8], cols[..., 8 * s:8 * s + 8, :])
    return acc


def _h(exc, w0, hbias, edge0, edge_t, i, p, cc):
    """h of block i's pass p for every CTA and warpgroup, before leaky_relu:
    (B, tiles, 2, 64, 136); the rows u (tiles, 2, 64); where h is in [0, T)
    and within Cc."""
    t = exc.shape[1]
    ntiles = -(-t // TILE)
    u = (np.arange(ntiles)[:, None, None] * TILE + OWN * np.arange(2)[None, :, None] - 1
         + np.arange(ROWS)[None, None, :])
    acc = h_at(exc, w0, hbias, edge0, edge_t, i, p, cc, u)
    ok = (u >= 0) & (u < t)
    chan_ok = PASS * p + np.arange(PASS) < cc
    return acc, u, ok[None, ..., None] & chan_ok


def k1_wide(e, npass):
    """K1's general instances (fwd_plan): Cc past one pass, or K = 3E + 3 past
    4 k-slices (X then made per item of the ring, not kept)."""
    return npass > 1 or -(-(3 * e + 3) // 8) > 4


def k1_width(two_c, wide):
    """The output columns of one of K1's chunks (fwd_plan): 32, 64, or 128
    (at most 64 in the general instances)."""
    return 32 if two_c <= 32 else 64 if two_c <= 64 or wide else 128


def k1_emulated(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """The chain's forward as K1 takes it (numpy f32 in, out): h once a tile
    and pass for every output chunk of the CTA's column; outside the general
    instances where W <= 64 (the taps as P's N), P_j = A @ W1_i[j] in an
    accumulator of its own and out = ((b1 + P_0[r]) + P_1[r + 1]) + P_2[r + 2];
    else P += A(rows j ..) @ W1_i[j] tap after tap in one accumulator over
    every pass, out = b1 + P[r]. A column's sums do not depend on its chunk."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    ntiles = -(-t // TILE)
    npass = -(-cc // PASS)
    wide = k1_wide(e, npass)
    taps_n = not wide and k1_width(two_c, wide) <= 64
    out = np.zeros((b, t, n * two_c), np.float32)
    for i in range(n):
        pacc = np.zeros((3 if taps_n else 1, b, ntiles, 2, ROWS, two_c), np.float32)
        for p in range(npass):
            h, u, ok = _h(exc, w0, hbias, edge0, edge_t, i, p, cc)
            a = np.where(ok, np.where(h >= 0, h, SLOPE * h), 0).astype(np.float32)
            # rows 64 and 65, which only the dropped output rows read
            a = np.concatenate([a, np.zeros_like(a[..., :2, :])], -2)
            for s in range(-(-min(PASS, cc - PASS * p) // 8)):
                for j in range(3):
                    w = np.zeros((8, two_c), np.float32)
                    rows = np.arange(PASS * p + 8 * s, PASS * p + 8 * s + 8)
                    w[rows < cc] = w1[j][rows[rows < cc], i * two_c:(i + 1) * two_c]
                    if taps_n:
                        add3(pacc[j], a[..., :ROWS, 8 * s:8 * s + 8], w)
                    else:
                        add3(pacc[0], a[..., j:j + ROWS, 8 * s:8 * s + 8], w)
        bias = b1[i * two_c:(i + 1) * two_c]
        if taps_n:
            own = ((bias + pacc[0][..., :OWN, :]) + pacc[1][..., 1:OWN + 1, :]) \
                + pacc[2][..., 2:OWN + 2, :]
        else:
            own = bias + pacc[0][..., :OWN, :]
        out[:, :, i * two_c:(i + 1) * two_c] = own.reshape(b, -1, two_c)[:, :t]
    return out


def w1_image_slice(w1, i, two_c, oc, w, c0, perm=False):
    """K1's image of W1 for block i, output chunk oc (w columns) and the
    k-slice of channels c0 .. c0 + 7, as k1_images_kernel writes it: 16-byte
    units (hi or lo) * 3 + tap, each a w-row x 8 k K-major image; as words.
    ``perm``: position k holds the slice's channel perm(k) (the k order of
    K1's W = 32 instance, whose A takes h's accumulator registers as they
    lie)."""
    cc = w1.shape[1]
    jh, r = np.divmod(np.arange(6 * 2 * w), 2 * w)
    o = oc * w + (r // 16) * 8 + r % 8
    k0 = ((r % 16) // 8)[:, None] * 4
    e = np.arange(4)[None]
    c = c0 + (2 * e + k0 // 4 if perm else k0 + e)
    ok = (c < cc) & (o < two_c)[:, None]
    v = np.where(ok, w1[(jh % 3)[:, None], np.minimum(c, cc - 1),
                        i * two_c + np.minimum(o, two_c - 1)[:, None]], 0).astype(np.float32)
    hi, lo = split(v)
    return np.where((jh // 3 == 0)[:, None], hi, lo).reshape(-1)


def perm(k):
    """dexc's K order: the image's column k holds the slice's channel perm(k)."""
    return 2 * k if k < 4 else 2 * (k - 4) + 1


def dh_as_a(d):
    """The A fragment of dexc's k-slice from dh's accumulators d (..., 64, 8)
    as a thread holds them: d[4s + v] = D[row + 8 (v >> 1)][2 tig + (v & 1)]
    goes to a[0] = d0, a[1] = d2, a[2] = d1, a[3] = d3, where a[v] is
    A[row + 8 (v & 1)][tig + 4 (v >> 1)]."""
    a = np.empty_like(d)
    for tig in range(4):
        for v, dv in enumerate((0, 2, 1, 3)):
            assert v & 1 == dv >> 1  # a[v] and d[dv] lie in the same row
            a[..., tig + 4 * (v >> 1)] = d[..., 2 * tig + (dv & 1)]
    return a


def scratch_a(e):
    """K2 takes lrelu(h) from the data kernel (make_plan's wide E) where Wh's
    image is more than one fetch of k2_w1_kernel, K = 3E + 3 past 32; else
    k2_w1_kernel recomputes it, and the data kernel takes X^T dh on chip."""
    return -(-(3 * e + 3) // 8) > WH_CHUNK


RUN_TILES = 8      # tiles a data-kernel CTA walks at most: 16 units of 62 rows a partial


def k2_plan(b, t, n, cc, run=None):
    """(run, nruns): the data kernel's runs of tiles of one batch row
    (make_plan): at most RUN_TILES, as long as make the CTAs' waves on the
    card take least, a wave of runs of r tiles counted as r + 1/4, the
    longest run first where two take as long. ``run`` given: that run."""
    ntiles = -(-t // TILE)
    if run is None:
        per_run = b * n * -(-cc // PASS)
        best = None
        for r in range(min(RUN_TILES, ntiles), 0, -1):
            cost = -(-per_run * -(-ntiles // r) // SM_COUNT) * (4 * r + 1)
            if best is None or cost < best:
                best, run = cost, r
    return run, -(-ntiles // run)


def k2_data_emulated(exc, w0, hbias, w1, g, edge0=None, edge_t=None, run=None):
    """K2's data kernel tile by tile, block by block and pass by pass: (dexc,
    the dh scratch (None at E <= 9), db1's partials (B, tiles, n*2C), h of
    every tile's rows with those rows (for the recompute's check), the
    lrelu(h) scratch (None where k2_w1_kernel recomputes it), at E <= 9 X^T
    dh's partials (B nruns, K, n*Cc) and nruns (else None, None))."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    ntiles = -(-t // TILE)
    npass = -(-cc // PASS)
    n0 = n * cc
    wide = scratch_a(e)
    dh_s = np.zeros((b, t, n0), np.float32) if wide else None
    a_s = np.zeros((b, t, n0), np.float32) if wide else None
    # dexc per block and pass (a part each), summed in order by the reduce
    dexc_p = np.zeros((n * npass, b, t, e), np.float32)
    pb1 = np.zeros((b, ntiles, n * two_c), np.float32)
    kx = 3 * e + 3
    run, nruns = k2_plan(b, t, n, cc, run)
    pw0 = None if wide else np.zeros((b * nruns, kx, n0), np.float32)
    hs = {}
    # g's 128-row stage of each tile: times t0 - 2 .. t0 + 125, zero outside [0, T)
    tt = np.arange(ntiles)[:, None] * TILE - 2 + np.arange(TILE + 4)[None]
    gt = np.where(((tt >= 0) & (tt < t))[None, ..., None],
                  g[:, np.clip(tt, 0, t - 1)], 0).astype(np.float32)
    for i in range(n):
        gi = gt[..., i * two_c:(i + 1) * two_c]
        for p in range(npass):
            h, u, ok = _h(exc, w0, hbias, edge0, edge_t, i, p, cc)
            hs[i, p] = h, u
            own = (np.arange(ROWS) >= 1) & (np.arange(ROWS) <= OWN)
            own = own[None, None, None, :, None] & ok
            chans = slice(i * cc + PASS * p, i * cc + min(PASS * (p + 1), cc))
            width = chans.stop - chans.start
            if wide:
                put_own(a_s, np.where(h >= 0, h, SLOPE * h), own, u, chans, width)
            # da: tap j reads g's stage rows 62 w + q + 2 - j
            da = np.zeros_like(h)
            for so in range(-(-two_c // 8)):
                for j in range(3):
                    rows = OWN * np.arange(2)[:, None] + np.arange(ROWS)[None] + 2 - j
                    gw = np.zeros((b, ntiles, 2, ROWS, 8), np.float32)
                    o = np.arange(8 * so, min(8 * so + 8, two_c))
                    gw[..., :len(o)] = gi[:, :, rows][..., o]
                    wt = np.zeros((8, PASS), np.float32)
                    wt[:len(o), :width] = w1[j][PASS * p:PASS * p + width, i * two_c + o].T
                    add3(da, gw, wt)
            dh = np.where(ok, np.where(h >= 0, da, SLOPE * da), 0).astype(np.float32)
            if wide:
                put_own(dh_s, dh, own, u, chans, width)
            else:
                # X^T dh of each tile's two windows (X's halo rows zero), k-slice
                # by k-slice of 8 rows; each window's sums take its tiles in
                # order, the two sums added at the run's end
                x = x_rows(exc, u.reshape(-1)).reshape(b, ntiles, 2, ROWS, -1)
                x = np.pad(x, [(0, 0)] * 4 + [(0, 32 - x.shape[-1])])
                x[..., [0, ROWS - 1], :] = 0
                d = np.zeros((b, ntiles, 2, PASS, 32), np.float32)
                for ks in range(ROWS // 8):
                    rows = slice(8 * ks, 8 * ks + 8)
                    add3(d, dh[..., rows, :].swapaxes(-1, -2), x[..., rows, :])
                for r_i in range(nruns):
                    sums = np.zeros((b, 2, PASS, 32), np.float32)
                    for tile in range(r_i * run, min(ntiles, (r_i + 1) * run)):
                        sums += d[:, tile]
                    part = sums[:, 0] + sums[:, 1]
                    pw0[np.arange(b) * nruns + r_i, :, chans] = \
                        part[:, :width, :kx].swapaxes(-1, -2)
            # dexc: P = dh @ W0 taps per chunk of 8 columns of exc, K permuted,
            # every slice of the pass
            for ec in range(-(-e // 8)):
                pac = np.zeros((b, ntiles, 2, ROWS, 24), np.float32)
                for s_ in range(PASS // 8):
                    w = np.zeros((8, 24), np.float32)
                    for j in range(3):
                        for k in range(8):
                            c = PASS * p + 8 * s_ + perm(k)
                            ee = np.arange(8 * ec, min(8 * ec + 8, e))
                            if c < cc:
                                w[k, 8 * j:8 * j + len(ee)] = w0[j][ee, i * cc + c]
                    add3(pac, dh_as_a(dh[..., 8 * s_:8 * s_ + 8]), w)
                v = (pac[..., 2:OWN + 2, 0:8] + pac[..., 1:OWN + 1, 8:16]) + pac[..., :OWN, 16:24]
                v = v.reshape(b, -1, 8)[:, :t, :min(8, e - 8 * ec)]
                dexc_p[i * npass + p][..., 8 * ec:8 * ec + v.shape[-1]] = v
        # db1: each tile's rows of g, per channel
        pb1[..., i * two_c:(i + 1) * two_c] = gi[:, :, 2:TILE + 2].sum(2)
    return reduce_sum(dexc_p), dh_s, pb1, hs, a_s, pw0, None if wide else nruns


# --- k2_w1_kernel and k2_xdh_kernel, as their threads read and write shared memory

UNIT = 64          # a's rows a unit of k2_w1_kernel (its products' K)
GBOX = 68 * 8      # floats of a box of 8 channels of g in a stage (66 rows used)
AGROUP = 2048      # bytes of 8 columns of a's image, every row (SBO)
AIMG = 17 * AGROUP  # bytes of a's image, hi or lo
SM_COUNT = 132
WH_CHUNK = 4       # k-slices of Wh's image k2_w1_kernel fetches at once
W1_RUN = 16        # units a run of k2_w1_kernel's accumulators takes at most (wgmma's drift)


def ordered_sum(parts):
    """parts summed along axis 0, one after the other."""
    acc = np.zeros_like(parts[0])
    for x in parts:
        acc += x
    return acc


REDUCE_LANES = 32    # lanes of a warp the reduce gives an output of a long sum
REDUCE_LONG = 256    # partials past which the reduce takes an output's sum by a warp
REDUCE_FEW = 1 << 16  # ... in a job of fewer outputs than this


def takes_lanes(outputs, s):
    """Whether the reduce's job of ``outputs`` sums of ``s`` partials each
    takes REDUCE_LANES threads an output (add_job)."""
    return s > REDUCE_LONG and outputs < REDUCE_FEW


def reduce_sum(parts, outputs=None):
    """parts summed along axis 0 as k2_reduce_kernel sums them: in order; past
    REDUCE_LONG partials, in a job of fewer than REDUCE_FEW outputs (those of
    parts[0] unless given), each lane's run of ceil(S / 32) consecutive ones
    in order, then the 32 runs' sums in order."""
    s = len(parts)
    if outputs is None:
        outputs = np.asarray(parts[0]).size
    if not takes_lanes(outputs, s):
        return ordered_sum(parts)
    per = -(-s // REDUCE_LANES)
    acc = np.zeros_like(parts[0])
    for lane in range(REDUCE_LANES):
        acc += ordered_sum(parts[lane * per:(lane + 1) * per]) if lane * per < s else 0
    return acc


def reduce_jobs(b, t, e, n, cc, two_c):
    """The reduce's jobs as cond_chain_bwd_f32 adds them, per-row hbias and
    the edges, as (outputs, partials): dexc's parts (with more than one
    block or pass), dW1's slots, db1's (batch row, tile) partials, dW0's,
    dhbias's and the edges' (batch row, part) partials."""
    npass = -(-cc // PASS)
    n0, n2 = n * cc, n * two_c
    if -(-(3 * e + 3) // 8) <= WH_CHUNK:
        parts = k2_plan(b, t, n, cc)[1]
    else:
        parts = xdh_parts(b, t, n0, 3 * e + 3)[0]
    jobs = [(b * t * e, n * npass)] if n * npass > 1 else []
    jobs += [(3 * cc * n2, w1_plan(b, t, n, npass, two_c)[-1]), (n2, b * -(-t // TILE)),
             (3 * e * n0, b * parts)]
    return jobs + [(b * n0, parts)] * 3


def reduce_threads(jobs):
    """k2_reduce_kernel's threads over ``jobs`` [(outputs, partials)] as
    add_job lays them out, a job that takes lanes (``takes_lanes``) from the
    next whole warp on: for each thread x its job (the last one to start at
    or before x), its output (x - first) / lanes, its lane, and whether the
    output is one of its job's (the threads of the gap before a job that
    takes lanes fall past the end of the job before, and return); then each
    job's first thread and lanes."""
    first, lanes, total = [], [], 0
    for outputs, s in jobs:
        ln = REDUCE_LANES if takes_lanes(outputs, s) else 1
        if ln > 1:
            total = -(-total // REDUCE_LANES) * REDUCE_LANES
        first.append(total)
        lanes.append(ln)
        total += outputs * ln
    first, lanes = np.array(first), np.array(lanes)
    x = np.arange(total)
    j = np.searchsorted(first, x, side="right") - 1
    rel = x - first[j]
    out = rel // lanes[j]
    return j, out, rel % lanes[j], out < np.array([o for o, _ in jobs])[j], first, lanes


def kmajor_store(img, c, k, v):
    """Element (row c, k) of a K-major core-matrix image (rows of 64 k, 8-row
    groups 2048 bytes apart, 4-k halves 128): the words of ``img`` at
    (c / 8) 2048 + (k / 4) 128 + (c % 8) 16 + (k % 4) 4 bytes."""
    img[((c // 8) * 2048 + (k // 4) * 128 + (c % 8) * 16 + (k % 4) * 4) // 4] = v


def desc_read(img, start, rows, lbo, sbo):
    """The rows x 8 K-major operand a wgmma descriptor reads at byte
    ``start`` of ``img``: element (r, k) at start + (r / 8) sbo + (k / 4) lbo
    + (r % 8) 16 + (k % 4) 4."""
    r, k = np.arange(rows)[:, None], np.arange(8)[None]
    return img[(start + (r // 8) * sbo + (k // 4) * lbo + (r % 8) * 16 + (k % 4) * 4) // 4]


def add3s(acc, a, b):
    """acc += a @ b^T of operands split already ((hi, lo) each): lo.hi, hi.lo,
    hi.hi, in that order."""
    for x, y in ((a[1], b[0]), (a[0], b[1]), (a[0], b[0])):
        acc += np.matmul(x, y.T, dtype=np.float32)
    return acc


def w1_plan(b, t, n, npass, two_c):
    """k2_w1_kernel's plan (make_plan): (OT, o-tiles, units a batch row,
    units a tile, items a CTA, CTAs, partial slots S). The items (tile,
    unit), tile-major, in equal runs over SM_COUNT CTAs; S the most CTAs
    any tile's units span."""
    ot = 32 if two_c <= 32 else 64
    notiles = -(-two_c // ot)
    nsub = -(-t // UNIT)
    units = b * nsub
    tiles = n * npass * notiles
    per_cta = -(-(tiles * units) // SM_COUNT)
    ctas = -(-(tiles * units) // per_cta)
    slots = max(((tau + 1) * units - 1) // per_cta - tau * units // per_cta + 1
                for tau in range(tiles))
    return ot, notiles, nsub, units, per_cta, ctas, slots


def w1_segments(plan, tiles):
    """(CTA, tile, partial slot, the tile's units k) of each segment, in the
    order each CTA walks them: a CTA's items cut where a tile ends; the slot
    is the CTA's place among the tile's CTAs."""
    _, _, _, units, per_cta, ctas, _ = plan
    out = []
    for cta in range(ctas):
        x, x1 = cta * per_cta, min(tiles * units, (cta + 1) * per_cta)
        while x < x1:
            tau = x // units
            end = min(x1, (tau + 1) * units)
            out.append((cta, tau, cta - tau * units // per_cta,
                        list(range(x - tau * units, end - tau * units))))
            x = end
    return out


def w1_emulated(exc, w0, hbias, w1, g, edge0, edge_t, hs, a_s=None):
    """dW1 (3, Cc, n*2C) as k2_w1_kernel takes it: per item, a recomputed
    (checked bit for bit against the data kernel's h at the same rows,
    ``hs``), or read from the data kernel's scratch ``a_s`` at wide E (the
    same bits), into its K-major image; A = g^T from the stage's rows shifted
    by the tap; per segment (``w1_segments``) the accumulators' runs of at
    most W1_RUN units summed in order into its partial slot, then the slots
    reduced in order (slots a tile's CTAs do not fill are zero)."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    npass = -(-cc // PASS)
    plan = w1_plan(b, t, n, npass, two_c)
    ot, notiles, nsub, units, _, _, nslots = plan
    nch = -(-3 * ot // 64)
    n2 = n * two_c
    pw1 = np.zeros((nslots, 3, cc, n2), np.float32)
    r = np.arange(64 * nch)
    j_r, o_r = r // ot, r % ot
    cl, q = np.meshgrid(np.arange(PASS), np.arange(UNIT), indexing="ij")
    a_of, b_of = {}, {}  # a (B, nsub, 64, 136) of each (block, pass); B's reads of each unit
    for i in range(n):
        for p in range(npass):
            c0 = PASS * p
            u = np.arange(nsub)[:, None] * UNIT + np.arange(UNIT)[None]
            h = h_at(exc, w0, hbias, edge0, edge_t, i, p, cc, u)  # (B, nsub, 64, 136)
            # the same bits as the data kernel's h at every row it owns
            hd, ud = hs[i, p]
            own = ud[:, :, 1:OWN + 1]
            rows = own[own < t]
            np.testing.assert_array_equal(h[:, rows // UNIT, rows % UNIT],
                                          hd[:, :, :, 1:OWN + 1][:, own < t])
            ok = (u < t)[None, ..., None] & (c0 + np.arange(PASS) < cc)
            a = np.where(ok, np.where(h >= 0, h, SLOPE * h), 0).astype(np.float32)
            if a_s is not None:
                cols = np.clip(i * cc + c0 + np.arange(PASS), 0, n * cc - 1)
                read = np.where(ok, a_s[:, np.clip(u, 0, t - 1)][..., cols], 0)
                np.testing.assert_array_equal(read, a)
                a = read.astype(np.float32)
            a_of[i, p] = a
    tiles = n * npass * notiles
    for _, tau, slot, ks in w1_segments(plan, tiles):
        ip, oti = divmod(tau, notiles)
        i, p = divmod(ip, npass)
        c0, o0 = PASS * p, oti * ot
        part = None
        for r0 in range(0, len(ks), W1_RUN):
            acc = np.zeros((64 * nch, PASS), np.float32)
            for k in ks[r0:r0 + W1_RUN]:
                bb, sub = divmod(k, nsub)
                s0 = sub * UNIT
                if (i, p, k) not in b_of:
                    img = np.zeros(2 * AIMG // 4, np.float32)
                    hi, lo = split(a_of[i, p][bb, sub].T)  # (136 c, 64 s)
                    kmajor_store(img, cl, q, hi)
                    kmajor_store(img[AIMG // 4:], cl, q, lo)
                    b_of[i, p, k] = [(desc_read(img, 256 * kk, PASS, 128, AGROUP),
                                      desc_read(img, AIMG + 256 * kk, PASS, 128, AGROUP))
                                     for kk in range(UNIT // 8)]
                # the g stage: rows s0 - 1 .. s0 + 64 of channels o0 .., in boxes of 8
                stage = np.zeros((ot // 8, 68, 8), np.float32)
                rows = np.arange(s0 - 1, s0 + 67)
                rok = (rows >= 0) & (rows < t) & (np.arange(68) < UNIT + 2)
                for bx in range(ot // 8):
                    oo = o0 + 8 * bx + np.arange(8)
                    cols = oo < two_c
                    stage[bx][np.ix_(rok, cols)] = g[bb, rows[rok]][:, i * two_c + oo[cols]]
                flat = stage.reshape(-1)
                for kk in range(UNIT // 8):
                    kcol = np.arange(8)[None]
                    idx = (o_r // 8)[:, None] * GBOX + (2 - j_r[:, None] + kcol) * 8 \
                        + (o_r % 8)[:, None] + 64 * kk
                    av = np.where((r < 3 * ot)[:, None], flat[np.clip(idx, 0, None)], 0)
                    add3s(acc, split(av.astype(np.float32)), b_of[i, p, k][kk])
            part = acc if part is None else part + acc
        width = min(PASS, cc - c0)
        for rr in range(3 * ot):
            o = o0 + o_r[rr]
            if o < two_c:
                pw1[slot, j_r[rr], c0:c0 + width, i * two_c + o] = part[rr, :width]
    return reduce_sum(pw1)


def xdh_parts(b, t, n0, kx):
    """(parts a batch row, rows a part) of k2_xdh_kernel (make_plan): CTAs
    of (128 columns of dh, 32 of X, a part), at least 8 an SM, parts of whole
    steps of 64 rows."""
    per_b = b * -(-n0 // 128) * -(-kx // 32)
    parts = min(max(1, -(-8 * SM_COUNT // per_b)), 65535 // b)
    prows = -(-(-(-t // parts)) // 64) * 64
    return -(-t // prows), prows


def xdh_emulated(exc, dh_s, kx):
    """X^T dh as k2_xdh_kernel takes it: per CTA (128 columns of dh, 32 of X,
    one part of a batch row), X's K-major image built per step of 64 rows,
    A = dh^T from the raw stage; (B parts, K, n*Cc) partials, parts a batch
    row."""
    b, t, e = exc.shape
    n0 = dh_s.shape[-1]
    xks = -(-kx // 32)
    parts, prows = xdh_parts(b, t, n0, kx)
    pw0 = np.zeros((b * parts, kx, n0), np.float32)
    kk8, tg = np.meshgrid(np.arange(32), np.arange(64), indexing="ij")
    for sp in range(b * parts):
        bb, part = divmod(sp, parts)
        r0 = part * prows
        r1 = min(t, r0 + prows)
        u = np.arange(r0, r0 + -(-(r1 - r0) // 64) * 64)
        x_all = x_rows(exc[bb:bb + 1], u)[0]              # (rows, K8)
        x_all[u >= r1] = 0
        x_all = np.pad(x_all, ((0, 0), (0, xks * 32 - x_all.shape[1]))) \
            if x_all.shape[1] < xks * 32 else x_all
        for col0 in range(0, n0, 128):
            for k0 in range(0, xks * 32, 32):
                tot = np.zeros((128, 32), np.float32)
                for st in range(len(u) // 64):
                    acc = np.zeros((128, 32), np.float32)  # a step's, then added to tot
                    t0 = r0 + 64 * st
                    img = np.zeros(2 * 8192 // 4, np.float32)
                    hi, lo = split(x_all[64 * st:64 * st + 64, k0:k0 + 32].T)  # (32 k, 64 t)
                    kmajor_store(img, kk8, tg, hi)
                    kmajor_store(img[8192 // 4:], kk8, tg, lo)
                    # the dh stage: 16 boxes of 8 columns x 64 rows, zeros past T and n0
                    stage = np.zeros((16, 64, 8), np.float32)
                    rows = np.arange(t0, t0 + 64)
                    for q in range(16):
                        cols = col0 + 8 * q + np.arange(8)
                        okc = cols < n0
                        rok = rows < t
                        stage[q][np.ix_(rok, okc)] = dh_s[bb][np.ix_(rows[rok], cols[okc])]
                    flat = stage.reshape(-1)
                    m, kc = np.arange(64)[:, None], np.arange(8)[None]
                    for kk in range(8):
                        fb = (desc_read(img, 256 * kk, 32, 128, 2048),
                              desc_read(img, 8192 + 256 * kk, 32, 128, 2048))
                        for wg in range(2):
                            idx = (8 * wg + m // 8) * 512 + kc * 8 + m % 8 + 64 * kk
                            add3s(acc[64 * wg:64 * wg + 64], split(flat[idx]), fb)
                    tot += acc
                keep = min(32, kx - k0)
                width = min(128, n0 - col0)
                if keep > 0:
                    pw0[sp, k0:k0 + keep, col0:col0 + width] = tot[:width, :keep].T
    return pw0, parts


def k2_emulated(exc, w0, hbias, w1, g, edge0=None, edge_t=None, run=None):
    """The chain's backward as K2 takes it: the data kernel tile by tile (at
    E <= 9 with X^T dh), then k2_w1_kernel, past E = 9 k2_xdh_kernel, and the
    ordered reduce of their partials. ``run``: the data kernel's runs of
    tiles, where not make_plan's."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    dexc, dh_s, pb1, hs, a_s, pw0, parts = k2_data_emulated(exc, w0, hbias, w1, g, edge0,
                                                            edge_t, run)
    out = dict(exc=dexc, b1=reduce_sum(pb1.reshape(-1, n * two_c)))
    out["w1"] = w1_emulated(exc, w0, hbias, w1, g, edge0, edge_t, hs, a_s)
    if pw0 is None:
        pw0, parts = xdh_emulated(exc, dh_s, 3 * e + 3)
    out["w0"] = reduce_sum(pw0[:, :3 * e]).reshape(3, e, n * cc)
    per_b = pw0.reshape(b, parts, *pw0.shape[1:])
    rows = b * n * cc  # the per-row jobs' outputs
    dhb = np.stack([reduce_sum(per_b[bb, :, 3 * e], rows) for bb in range(b)])
    out["hbias"] = dhb if hbias.ndim == 2 else reduce_sum(pw0[:, 3 * e])
    if edge0 is not None:
        out.update(edge0=np.stack([reduce_sum(per_b[bb, :, 3 * e + 1], rows) for bb in range(b)]),
                   edge_t=np.stack([reduce_sum(per_b[bb, :, 3 * e + 2], rows)
                                    for bb in range(b)]))
    return out


def put_own(dst, src, own, u, chans, width):
    """The own rows of src (B, tiles, 2, 64, 136) into dst (B, T, n*Cc)."""
    for tile in range(src.shape[1]):
        for w in range(2):
            rows = np.nonzero(own[0, tile, w, :, 0])[0]
            dst[:, u[tile, w, rows], chans] = src[:, tile, w][:, rows, :width]


def assert_parity(got, want, name):
    scale = float(np.abs(want).max())
    d = float(np.abs(got - want).max())
    assert d <= testing.PARITY_RTOL * scale, f"{name}: max|d| {d:.3e} of max|ref| {scale:.3e}"


def operands(split_form, b, t, e, n, cc, two_c, seed, scale=0.3):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    ein = e if split_form else cc
    ops = dict(exc=r(b, t, ein), w0=r(3, ein, n * cc),
               hbias=r(b, n * cc) if split_form else r(n * cc), w1=r(3, cc, n * two_c),
               b1=r(n * two_c))
    if split_form:
        ops.update(edge0=r(b, n * cc), edge_t=r(b, n * cc))
    return ops


# (form, B, T, E, n, Cc, 2C): one ragged tile; three tiles and two passes of
# 136 channels with 2C past one output chunk; the concat form (E = Cc)
# with E past one chunk of dexc's 8 columns
CASES = [(True, 2, 100, 8, 2, 20, 8), (True, 1, 300, 6, 1, 150, 40),
         (False, 2, 130, 0, 2, 12, 12)]
IDS = ["split-one-tile", "split-two-passes", "concat-E12"]


# K1's cases add each chunk width with the taps as N or not, over several
# tiles of several batch rows with a ragged last tile: W = 32 (2C = 32,
# three rows of three tiles), W = 64 (four tiles, the last of 28 rows), W = 128
# (one chunk; and 2C = 256, two chunks); and a concat form of two passes
# (Cc = 150) whose 2C = 136 takes three chunks of 64, the last ragged
K1_CASES = CASES + [(True, 3, 300, 8, 2, 16, 32), (True, 2, 400, 8, 2, 24, 64),
                    (True, 1, 130, 8, 1, 16, 128), (True, 2, 260, 8, 1, 20, 256),
                    (False, 1, 140, 0, 1, 150, 136)]
K1_IDS = IDS + ["W32-three-rows", "W64-ragged", "W128", "W128-two-chunks",
                "concat-two-passes-three-chunks"]


@pytest.mark.parametrize("split_form,b,t,e,n,cc,two_c", K1_CASES, ids=K1_IDS)
def test_k1_emulation_matches_plain(split_form, b, t, e, n, cc, two_c):
    ops = operands(split_form, b, t, e, n, cc, two_c, seed=t + cc)
    want = cond_chain.cond_chain_plain(**ops).numpy()
    assert_parity(k1_emulated(**np32(ops)), want, "K1")


@pytest.mark.parametrize("w,permuted", [(32, True), (64, False), (128, False)])
def test_k1_w1_image_read_back(w, permuted):
    """P's B read back through K1's descriptors from the image of W1 that
    k1_images_kernel writes: the three taps side by side as N (3w rows, hi
    at 0, lo 3w * 32 bytes on) and each tap alone (w rows at j w * 32
    bytes), both the split of W1's columns of the chunk; at W = 32 each
    slice's k order permuted (position k: column perm(k)), which reads A's
    lo from h's accumulator registers as they lie (dh_as_a's layout)."""
    rng = np.random.default_rng(w)
    n, cc, two_c = 2, 20, w + w // 2  # a second, ragged chunk
    w1 = rng.standard_normal((3, cc, n * two_c)).astype(np.float32)
    order = [perm(k) for k in range(8)] if permuted else list(range(8))
    for i, oc, c0 in ((1, 0, 8), (0, 1, 16)):
        img = w1_image_slice(w1, i, two_c, oc, w, c0, permuted)
        cols = oc * w + np.arange(w)
        ks = c0 + np.arange(8)
        want = np.zeros((3, w, 8), np.float32)
        for j in range(3):
            ok = (cols < two_c)[:, None] & (ks < cc)[None]
            want[j][ok] = w1[j][np.ix_(np.minimum(ks, cc - 1), i * two_c
                                       + np.minimum(cols, two_c - 1))].T[ok]
        hi, lo = split(want[..., order])
        np.testing.assert_array_equal(desc_read(img, 0, 3 * w, 128, 256), hi.reshape(3 * w, 8))
        np.testing.assert_array_equal(desc_read(img, 3 * w * 32, 3 * w, 128, 256),
                                      lo.reshape(3 * w, 8))
        for j in range(3):
            np.testing.assert_array_equal(desc_read(img, j * w * 32, w, 128, 256), hi[j])
            np.testing.assert_array_equal(desc_read(img, (3 + j) * w * 32, w, 128, 256), lo[j])


# K2's cases add E = 10 with Cc = 138 and 2C = 6, which the wrapper pads to
# 140 and 8 (two passes, k2_w1_kernel's 32-channel o-tile); 2C = 72 (two
# 64-channel o-tiles, the second ragged) over 18 units of 64 rows; and 36
# (block, pass, o-tile) tiles over 5 units, so that k2_w1_kernel's CTAs
# take runs of two units (the last of one); and the concat form at
# E = Cc = 48 (K = 147, 19 k-slices of Wh), where k2_w1_kernel reads
# lrelu(h) from the data kernel's scratch (as at every E past 9)
# The data kernel's runs: the last case gives runs of RUN_TILES tiles (the
# kernel's plan takes them at the step's B = 32, T = 4480; at a test's size
# it takes shorter ones) to a ragged row end, 12 tiles of which the last has
# 78 rows: one run of 8 tiles, each (batch row, run) partial of X^T dh at its
# limit of 16 units of 62 rows, and one of 4. Then E = 9, the last width
# with X^T dh in the data kernel (K = 30), and a concat form of two passes
# (E = Cc = 140), which takes the scratch route; and 2 x 130 tiles, so that
# db1's 260 partials are summed by a warp of the reduce
K2_CASES = CASES + [(True, 1, 70, 10, 1, 138, 6), (False, 2, 530, 0, 1, 16, 72),
                    (True, 1, 300, 8, 6, 150, 136), (False, 2, 150, 0, 1, 48, 40),
                    (True, 2, 200, 9, 2, 20, 16), (False, 1, 130, 0, 1, 140, 8),
                    (True, 1, 1442, 8, 1, 12, 8), (True, 2, 16000, 8, 1, 12, 8)]
K2_IDS = IDS + ["split-E10-padded", "concat-two-otiles", "split-runs-of-two",
                "concat-E48-a-scratch", "split-E9-on-chip", "concat-two-passes-scratch",
                "split-run-of-8-ragged", "split-db1-by-a-warp"]
K2_RUNS = {"split-run-of-8-ragged": RUN_TILES}


@pytest.mark.parametrize("split_form,b,t,e,n,cc,two_c", K2_CASES, ids=K2_IDS)
def test_k2_emulation_matches_plain(request, split_form, b, t, e, n, cc, two_c):
    """K2's kernels emulated at the widths the wrapper gives them, cut back:
    the data kernel (at E <= 9 with X^T dh, its partials per (batch row, run)
    of tiles), then k2_w1_kernel (lrelu(h) recomputed with the data kernel's
    bits, its K-major image, the tap shift on A) and past E = 9 k2_xdh_kernel
    (X^T dh with the ones and edge columns), their partials reduced in
    order."""
    ops = operands(split_form, b, t, e, n, cc, two_c, seed=t + cc + 1)
    ops.pop("b1")
    g = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (b, t, n * two_c)).astype(np.float32))
    want = cond_chain.cond_chain_bwd_plain(g=g, **ops)
    cc_p, two_c_p = cond_chain._padded_widths("bwd", cc, two_c)
    rest = {k: v for k, v in ops.items() if k != "exc"}
    padded = cond_chain._pad_widths({**rest, "g": g}, n, cc, two_c, cc_p, two_c_p)
    got = k2_emulated(exc=ops["exc"].numpy(), **np32(padded),
                      run=K2_RUNS.get(request.node.callspec.id))
    got = cond_chain._cut_grads({k: torch.from_numpy(v) for k, v in got.items()},
                                n, cc, two_c, cc_p, two_c_p)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_parity(got[k].numpy(), want[k].numpy(), f"d{k}")


def test_k2_plan_runs():
    """The data kernel's runs at the f32 step's shapes (B = 16 and 32, n = 9,
    one pass) fill the card: at least two waves of CTAs, a run at most 8
    tiles (16 units of 62 rows a partial of X^T dh)."""
    for b in (16, 32):
        for t in (280, 2240, 4480, 8960):
            run, nruns = k2_plan(b, t, 9, 136)
            assert 1 <= run <= RUN_TILES and (nruns - 1) * run < -(-t // TILE) <= nruns * run
            assert b * 9 * nruns >= 2 * SM_COUNT, (b, t, run)
    assert k2_plan(16, 280, 9, 136) == (1, 3)  # 432 CTAs where a CTA a tile made 48


def test_k2_w1_items_over_the_sms(monkeypatch):
    """k2_w1_kernel's plan at the f32 step's 8 shapes (n = 9, one pass): the
    items fill the card's 132 SMs in one wave, with at most 16 partial slots
    a tile. Then on a card of 5 SMs: 3 tiles (2C = 136: two o-tiles of 64
    and a ragged one of 8) of 42 units in runs of 26 items a CTA, so that
    CTAs cross from one tile into the next mid-run, segments hold more than
    one run of 16 units, and two tiles take 2 of the 3 slots (the reduce
    sums 3, the third zero); the whole backward emulated against the plain
    version."""
    plans = {(b, t, c2): w1_plan(b, t, 9, 1, c2) for b in (32, 16)
             for t, c2 in ((280, 256), (2240, 128), (4480, 64), (8960, 32))}
    assert plans[32, 280, 256] == (64, 4, 5, 160, 44, 131, 5)
    assert plans[32, 8960, 32] == (32, 1, 140, 4480, 306, 132, 16)
    assert plans[16, 4480, 64] == (64, 1, 70, 1120, 77, 131, 16)
    for ot, notiles, nsub, units, per_cta, ctas, slots in plans.values():
        assert SM_COUNT - 1 <= ctas <= SM_COUNT
        assert (ctas - 1) * per_cta < 9 * notiles * units <= ctas * per_cta and slots <= 16
    monkeypatch.setattr(sys.modules[__name__], "SM_COUNT", 5)
    plan = w1_plan(2, 1300, 1, 1, 136)
    assert plan == (64, 3, 21, 42, 26, 5, 3)
    assert [(cta, tau, slot, len(ks)) for cta, tau, slot, ks in w1_segments(plan, 3)] == [
        (0, 0, 0, 26), (1, 0, 1, 16), (1, 1, 0, 10), (2, 1, 1, 26), (3, 1, 2, 6), (3, 2, 0, 20),
        (4, 2, 1, 22)]
    ops = operands(True, 2, 1300, 8, 1, 20, 136, seed=13)
    ops.pop("b1")
    g = torch.from_numpy(np.random.default_rng(14).standard_normal((2, 1300, 136))
                         .astype(np.float32))
    want = cond_chain.cond_chain_bwd_plain(g=g, **ops)
    got = k2_emulated(exc=ops["exc"].numpy(), g=g.numpy(),
                      **np32({k: v for k, v in ops.items() if k != "exc"}))
    for k in want:
        assert_parity(got[k], want[k].numpy(), f"d{k}")


# The reduce's jobs: the smoke's guard case (split Cc = 140, 2C = 12, E = 8,
# B = 16, T = 2240), where dW1's 45,360 outputs leave a gap of 16 threads
# before db1's job of 304 partials, which takes lanes; the f32 step's last
# call (db1 by warps from the first whole warp on, no gap); and the options'
# bottleneck (E = Cc = 128, past E = 9: one thread an output throughout)
REDUCE_CASES = [(16, 2240, 8, 9, 140, 12, True), (16, 8960, 8, 9, 136, 32, False),
                (16, 224, 128, 1, 128, 256, False)]


@pytest.mark.parametrize("b,t,e,n,cc,two_c,gap", REDUCE_CASES,
                         ids=["gap-before-a-warp-job", "step-last-call", "bottleneck"])
def test_reduce_threads_write_each_output_once(b, t, e, n, cc, two_c, gap):
    """k2_reduce_kernel's threads (``reduce_threads``) at the jobs
    cond_chain_bwd_f32 adds: every output of every job written once, by lane
    0 of its thread group; a job that takes lanes starts on a warp and every
    thread of its warps is inside it (the shuffle needs all 32); the threads
    of a gap before such a job fall past the end of the job before and write
    nothing."""
    jobs = reduce_jobs(b, t, e, n, cc, two_c)
    j, out, lane, inside, first, lanes = reduce_threads(jobs)
    writes = inside & (lane == 0)
    for jj, (outputs, _) in enumerate(jobs):
        np.testing.assert_array_equal(np.sort(out[writes & (j == jj)]), np.arange(outputs))
        if lanes[jj] > 1:
            assert first[jj] % REDUCE_LANES == 0 and inside[j == jj].all()
    assert (~inside).any() == gap
    assert (lanes > 1).any() == (e <= 9)


def w1_exc_stage(exc, bb, s0):
    """The exc rows s0 - 1 .. s0 + 64 of batch row bb as w1_exc_rows stages
    them, zeros outside [0, T): element (r, e) at r E + e."""
    t, e = exc.shape[1:]
    rows = s0 - 1 + np.arange(UNIT + 2)
    ok = (rows >= 0) & (rows < t)
    stage = np.zeros((UNIT + 2, e), np.float32)
    stage[ok] = exc[bb, rows[ok]]
    return stage.reshape(-1)


def w1_x_words(stage, e, s0, t, quads):
    """X's image of a unit as w1_x_image writes it from the exc stage: thread
    quad x < 512 puts row q = x % 64, columns k = 4 kq .. 4 kq + 3 (kq = x /
    64), split, at (kq / 2) 2048 + (kq % 2) 1024 + 16 q bytes (hi; lo 8192
    on). Column k < 3E, tap j = k / E's column k - j E of the stage's row
    q + j, is the stage's word q E + k; then the ones, the edges, zeros.
    ``quads`` (E = 8): the four columns of quad kq < 6 read as one 16-byte
    word, quad 6 the ones and the edges, quad 7 zeros."""
    img = np.zeros(2 * 8192 // 4, np.float32)
    for x in range(512):
        q, kq = x & 63, x >> 6
        first, last = float(-(s0 + q == 0)), float(-(s0 + q == t - 1))
        if quads:
            v = (stage[q * 8 + 4 * kq:][:4] if kq < 6
                 else [1.0, first, last, 0.0] if kq == 6 else [0.0] * 4)
        else:
            v = []
            for k in range(4 * kq, 4 * kq + 4):
                v.append(stage[q * e + k] if k < 3 * e else
                         {3 * e: 1.0, 3 * e + 1: first, 3 * e + 2: last}.get(k, 0.0))
        hi, lo = split(np.asarray(v, np.float32))
        at = ((kq >> 1) * 2048 + (kq & 1) * 1024 + q * 16) // 4
        img[at:at + 4] = hi
        img[2048 + at:2048 + at + 4] = lo
    return img


@pytest.mark.parametrize("e,quads", [(8, True), (8, False), (6, False), (9, False)],
                         ids=["E8-quads", "E8", "E6", "E9"])
def test_w1_x_image_read_back(e, quads):
    """X's image in k2_w1_kernel's slot as its threads build it from a unit's
    staged exc rows (``w1_exc_stage``, ``w1_x_words``: element (q, k) at
    (k / 8) 2048 + (k % 8 / 4) 1024 + 16 q + (k % 4) 4 bytes, hi then lo 8192
    on; at E = 8 also by 16-byte quads), read back through h's A descriptors
    (64 rows q, LBO 1024, SBO 128, slice s 2048 s on), is X at the unit's
    rows (``x_rows``: the three taps, 1, -[u == 0], -[u == T-1], zeros to 32
    columns) split: the first unit, and the last unit of the second batch
    row, whose T ends mid-unit."""
    b, t = 2, 2 * UNIT + 37
    exc = np.random.default_rng(e).standard_normal((b, t, e)).astype(np.float32)
    for bb, s0 in ((0, 0), (1, 2 * UNIT)):
        img = w1_x_words(w1_exc_stage(exc, bb, s0), e, s0, t, quads)
        x = x_rows(exc[bb:bb + 1], s0 + np.arange(UNIT))[0]
        hi, lo = split(np.pad(x, ((0, 0), (0, 32 - x.shape[1]))))
        for s_ in range(4):
            np.testing.assert_array_equal(desc_read(img, 2048 * s_, ROWS, 1024, 128),
                                          hi[:, 8 * s_:8 * s_ + 8])
            np.testing.assert_array_equal(desc_read(img, 8192 + 2048 * s_, ROWS, 1024, 128),
                                          lo[:, 8 * s_:8 * s_ + 8])


def test_x_image_read_back():
    """X's image in the data kernel's shared memory (x_image: element (k, q)
    at (k / 8) 2048 + (q / 4) 128 + (k % 8) 16 + (q % 4) 4 bytes, hi then lo
    8192 on) read back as h's A registers (x_frag_image: the words x_frag
    makes from exc) and, its halo rows zeroed (x_halo), as X^T dh's B through
    the descriptors (32 rows k, SBO 2048, LBO 128, slice ks 256 ks on)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((ROWS, 32)).astype(np.float32)
    hi, lo = split(x)
    img = np.zeros(2 * 8192 // 4, np.float32)
    q, k = np.meshgrid(np.arange(ROWS), np.arange(32), indexing="ij")
    kmajor_store(img, k, q, hi)
    kmajor_store(img[8192 // 4:], k, q, lo)
    for wt in range(128):
        row, tig = (wt >> 5) * 16 + (wt & 31) // 4, wt % 4
        base = ((row >> 2) * 128 + tig * 16 + (row & 3) * 4) // 4
        for s_ in range(4):
            p0 = base + s_ * 512
            got = [img[p0], img[p0 + 64], img[p0 + 16], img[p0 + 80]]
            want = [(row, 8 * s_ + tig), (row + 8, 8 * s_ + tig), (row, 8 * s_ + tig + 4),
                    (row + 8, 8 * s_ + tig + 4)]
            assert got == [hi[r, c] for r, c in want]
            assert [img[p0 + 2048 + o] for o in (0, 64, 16, 80)] == [lo[r, c] for r, c in want]
    for wt in range(128):  # x_halo's word
        kk, w = wt & 31, wt >> 5
        off = (kk >> 3) * 2048 + (kk & 7) * 16 + (15 * 128 + 12 if w & 1 else 0)
        img[((w >> 1) * 8192 + off) // 4] = 0
    x0 = hi.copy()
    x0[[0, ROWS - 1]] = 0
    l0 = lo.copy()
    l0[[0, ROWS - 1]] = 0
    for ks in range(ROWS // 8):
        np.testing.assert_array_equal(desc_read(img, 256 * ks, 32, 128, 2048),
                                      x0[8 * ks:8 * ks + 8].T)
        np.testing.assert_array_equal(desc_read(img, 8192 + 256 * ks, 32, 128, 2048),
                                      l0[8 * ks:8 * ks + 8].T)


def test_dh_raw_reads():
    """dh raw in the data kernel's shared memory (box c / 8 of 64 rows x 8
    columns, element (q, c) at (c / 8) 512 + 8 q + c % 8 floats) read as
    dexc's A (one 8-byte load at row, 2 tig of a slice's box: A registers 0
    and 2; at row + 8: 1 and 3; dh_as_a's fragment in the permuted K order)
    and as X^T dh's A (element (m, kk) of slice ks: dh[8 ks + kk][cm + m])."""
    rng = np.random.default_rng(4)
    dh = rng.standard_normal((ROWS, PASS)).astype(np.float32)
    raw = dh.reshape(ROWS, PASS // 8, 8).transpose(1, 0, 2).reshape(-1)
    a = dh_as_a(dh.reshape(ROWS, PASS // 8, 8).transpose(1, 0, 2))  # (slices, 64, 8)
    for wt in range(128):
        row, tig = (wt >> 5) * 16 + (wt & 31) // 4, wt % 4
        for s_ in range(PASS // 8):
            p0 = s_ * 512 + row * 8 + 2 * tig
            assert [raw[p0], raw[p0 + 64], raw[p0 + 1], raw[p0 + 65]] == \
                [a[s_, row, tig], a[s_, row + 8, tig], a[s_, row, tig + 4], a[s_, row + 8, tig + 4]]
        for cm in (0, 64, 72):
            ap = ((cm >> 3) + 2 * (row >> 4)) * 512 + (row & 7) + 8 * tig
            for ks in range(ROWS // 8):
                p0 = ap + 64 * ks
                assert [raw[p0], raw[p0 + 512], raw[p0 + 32], raw[p0 + 544]] == \
                    [dh[8 * ks + tig, cm + row], dh[8 * ks + tig, cm + row + 8],
                     dh[8 * ks + tig + 4, cm + row], dh[8 * ks + tig + 4, cm + row + 8]]


def test_dexc_permutation_is_the_fragment_layout():
    """dh's accumulator pairs, read as the tf32 A fragment, are the k-slice's
    columns in the order perm gives: A[:, k] = D[:, perm(k)]."""
    d = np.arange(ROWS * 8, dtype=np.float32).reshape(ROWS, 8)
    a = dh_as_a(d)
    np.testing.assert_array_equal(a, d[:, [perm(k) for k in range(8)]])
    assert sorted(perm(k) for k in range(8)) == list(range(8))


# --- the wrapper's width repair: padding to each kernel's grain, cut back


def exact_operands(split_form, b, t, e, n, cc, two_c, seed):
    """Operands whose products and sums are exact in f32 in any order: values
    on a grid of 1/8 within [-1, 1], and h kept positive (hbias + 4), so that
    leaky_relu is the identity and no 0.2 enters."""
    ops = operands(split_form, b, t, e, n, cc, two_c, seed, scale=0.5)
    ops = {k: testing.dyadic(v.clamp(-1, 1), 1 / 8) for k, v in ops.items()}
    ops["hbias"] = ops["hbias"] + 4
    return ops


# (form, B, T, E, n, Cc, 2C): Cc = 11 and 138 (padded to 12 and 140 for K2),
# E = 6, 2C = 1030 (padded to 1032), and split Cc = 1290, past the old f32
# kernels' shared-memory cap (padded to 1292)
WIDTHS = [(True, 2, 9, 8, 3, 11, 6), (True, 1, 7, 6, 2, 138, 10), (False, 2, 5, 0, 1, 9, 1030),
          (True, 1, 5, 8, 1, 1290, 8)]
WIDTH_IDS = ["Cc11", "Cc138-E6", "2C1030", "Cc1290"]


@pytest.mark.parametrize("split_form,b,t,e,n,cc,two_c", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("kind", ["bwd", "bwd_bf16"])
def test_padding_is_exact(kind, split_form, b, t, e, n, cc, two_c):
    """The chain at padded widths, cut back, is the chain at the operands'
    widths: bit for bit on operands whose sums are exact in any order."""
    ops = exact_operands(split_form, b, t, e, n, cc, two_c, seed=cc + two_c)
    cc_p, two_c_p = cond_chain._padded_widths(kind, cc, two_c)
    assert cc_p % 4 == 0 and two_c_p % cond_chain._GRAIN[kind][1] == 0
    assert 0 <= cc_p - cc < 4 and 0 <= two_c_p - two_c < 8
    rest = {k: v for k, v in ops.items() if k != "exc"}
    padded = cond_chain._pad_widths(rest, n, cc, two_c, cc_p, two_c_p)
    out = cond_chain.cond_chain_plain(ops["exc"], **padded)
    assert torch.equal(cond_chain._cut_blocks(out, n, two_c_p, two_c),
                       cond_chain.cond_chain_plain(**ops))
    rest.pop("b1")
    g = testing.dyadic(torch.from_numpy(np.random.default_rng(cc).standard_normal(
        (b, t, n * two_c)).astype(np.float32)).clamp(-1, 1), 1 / 8)
    want = cond_chain.cond_chain_bwd_plain(ops["exc"], g=g, **rest)
    padded = cond_chain._pad_widths({**rest, "g": g}, n, cc, two_c, cc_p, two_c_p)
    got = cond_chain._cut_grads(cond_chain.cond_chain_bwd_plain(ops["exc"], **padded),
                                n, cc, two_c, cc_p, two_c_p)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("split_form,b,t,e,n,cc,two_c", WIDTHS, ids=WIDTH_IDS)
def test_kernel_route_pads_every_width(monkeypatch, split_form, b, t, e, n, cc, two_c):
    """Through the wrappers' own code, with each kernel's launch replaced by
    the plain version at the widths it is given (which must be the kernel's
    grain): every width runs, and the results are the plain version's at
    the operands' widths within the f32 tolerance (random operands, sums in
    another order)."""
    seen = []

    def fake_fwd(kind, exc, w0, hbias, w1, b1, edge0, edge_t, b, t, e, n, cc, two_c):
        seen.append((kind, cc, two_c))
        return cond_chain.cond_chain_plain(exc, w0, hbias, w1, b1, edge0, edge_t)

    def fake_bwd(kind):
        def run(exc, w0, hbias, w1, g, edge0, edge_t, b, t, e, n, cc, two_c):
            seen.append((kind, cc, two_c))
            return cond_chain.cond_chain_bwd_plain(exc, w0, hbias, w1, g, edge0, edge_t)
        return run

    monkeypatch.setattr(cond_chain, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(cond_chain, "_launch_bwd_f32", fake_bwd("bwd"))
    ops = operands(split_form, b, t, e, n, cc, two_c, seed=7)
    args = {"edge0": None, "edge_t": None, **ops}
    assert_parity(cond_chain._launch(**args).numpy(), cond_chain.cond_chain_plain(**ops).numpy(),
                  "K1 route")
    args.pop("b1")
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (b, t, n * two_c)).astype(np.float32))
    got = cond_chain._launch_bwd(g=g, **args)
    want = cond_chain.cond_chain_bwd_plain(g=g, **args)
    for k in want:
        assert_parity(got[k].numpy(), want[k].numpy(), f"K2 route d{k}")
    for kind, cc_k, two_c_k in seen:
        gc, g2 = cond_chain._GRAIN[kind]
        assert cc_k % gc == 0 and two_c_k % g2 == 0, (kind, cc_k, two_c_k)
    assert {k for k, *_ in seen} == {"fwd", "bwd"}
