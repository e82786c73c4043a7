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
- K2's data kernel: da from g's rows 62 w + q + 2 - j of the CTA's 128-row
  tile; dh = lrelu'(h) da, its own rows to the dh scratch; dexc as
  P = dh @ [W0_i[0]^T | W0_i[1]^T | W0_i[2]^T] with dh's accumulator pairs as
  the m16n8k8 A fragment (the image's K order permuted to match), then
  dexc[t] = P_0[t+1] + P_1[t] + P_2[t-1], summed over blocks and passes;
  db1 per CTA;
- k2_w1_kernel: per (block, pass, tile of 64 or 32 output channels) and
  64-row unit, lrelu(h) recomputed with the data kernel's bits (checked),
  written split into a K-major image (element (c, s) at (c / 8) 2048 +
  (s / 4) 128 + (c % 8) 16 + (s % 4) 4 bytes) and read back through the
  products' descriptors; A = g^T read from the raw TMA stage of g with the
  rows shifted by the tap, the three taps stacked as M = 64 rows (tap, o);
  a partial per run of at most 16 units;
- k2_xdh_kernel: X = [exc taps | 1 | -[t == 0] | -[t == T-1]] built per step
  of 64 rows into its K-major image, A = dh^T from the raw stage of the dh
  scratch, X^T dh per (batch row, part); the reduce sums every kind of
  partial in order.

Numpy and torch's CPU ops only, no JAX compile.
"""

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
    """K2 takes lrelu(h) from the data kernel (make_plan's scratch_a) where
    Wh's image is more than one fetch of k2_w1_kernel, K = 3E + 3 past 32;
    else k2_w1_kernel recomputes it."""
    return -(-(3 * e + 3) // 8) > WH_CHUNK


def k2_data_emulated(exc, w0, hbias, w1, g, edge0=None, edge_t=None):
    """K2's data kernel tile by tile and pass by pass: (dexc, the dh scratch, db1's partials
    (B, tiles, n*2C), h of every tile's rows with those rows (for the
    recompute's check), the lrelu(h) scratch (None where k2_w1_kernel
    recomputes it))."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    ntiles = -(-t // TILE)
    n0 = n * cc
    dh_s = np.zeros((b, t, n0), np.float32)
    a_s = np.zeros((b, t, n0), np.float32) if scratch_a(e) else None
    # dexc per pass of 136 channels (a CTA each), summed over the blocks in
    # order, then over the passes in order (the reduce)
    dexc_p = np.zeros((-(-cc // PASS), b, t, e), np.float32)
    pb1 = np.zeros((b, ntiles, n * two_c), np.float32)
    hs = {}
    # g's 128-row tile of each CTA: times t0 - 2 .. t0 + 125, zero outside [0, T)
    tt = np.arange(ntiles)[:, None] * TILE - 2 + np.arange(TILE + 4)[None]
    gt = np.where(((tt >= 0) & (tt < t))[None, ..., None],
                  g[:, np.clip(tt, 0, t - 1)], 0).astype(np.float32)
    for i in range(n):
        gi = gt[..., i * two_c:(i + 1) * two_c]
        for p in range(-(-cc // PASS)):
            h, u, ok = _h(exc, w0, hbias, edge0, edge_t, i, p, cc)
            hs[i, p] = h, u
            own = (np.arange(ROWS) >= 1) & (np.arange(ROWS) <= OWN)
            own = own[None, None, None, :, None] & ok
            chans = slice(i * cc + PASS * p, i * cc + min(PASS * (p + 1), cc))
            width = chans.stop - chans.start
            if a_s is not None:
                put_own(a_s, np.where(h >= 0, h, SLOPE * h), own, u, chans, width)
            # da: tap j reads g's tile rows 62 w + q + 2 - j
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
            put_own(dh_s, dh, own, u, chans, width)
            # dexc: P = dh @ W0 taps per chunk of 8 columns of exc, K permuted
            for ec in range(-(-e // 8)):
                pac = np.zeros((b, ntiles, 2, ROWS, 24), np.float32)
                for s in range(-(-width // 8)):
                    w = np.zeros((8, 24), np.float32)
                    for j in range(3):
                        for k in range(8):
                            c = PASS * p + 8 * s + perm(k)
                            ee = np.arange(8 * ec, min(8 * ec + 8, e))
                            if c < cc:
                                w[k, 8 * j:8 * j + len(ee)] = w0[j][ee, i * cc + c]
                    add3(pac, dh_as_a(dh[..., 8 * s:8 * s + 8]), w)
                v = (pac[..., 2:OWN + 2, 0:8] + pac[..., 1:OWN + 1, 8:16]) + pac[..., :OWN, 16:24]
                v = v.reshape(b, -1, 8)[:, :t, :min(8, e - 8 * ec)]
                dexc_p[p][..., 8 * ec:8 * ec + v.shape[-1]] += v
        # db1: each CTA's rows of g, per channel
        pb1[..., i * two_c:(i + 1) * two_c] = gi[:, :, 2:TILE + 2].sum(2)
    return ordered_sum(dexc_p), dh_s, pb1, hs, a_s


# --- k2_w1_kernel and k2_xdh_kernel, as their threads read and write shared memory

UNIT = 64          # a's rows a unit of k2_w1_kernel (its products' K)
GBOX = 68 * 8      # floats of a box of 8 channels of g in a stage (66 rows used)
AGROUP = 2048      # bytes of 8 columns of a's image, every row (SBO)
AIMG = 17 * AGROUP  # bytes of a's image, hi or lo
SM_COUNT = 132
WH_CHUNK = 4       # k-slices of Wh's image k2_w1_kernel fetches at once
W1_RUN = 16        # units of a run of k2_w1_kernel's accumulators at most (one partial each)


def ordered_sum(parts):
    """parts summed along axis 0, one after the other (the reduce's order)."""
    acc = np.zeros_like(parts[0])
    for x in parts:
        acc += x
    return acc


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


def w1_emulated(exc, w0, hbias, w1, g, edge0, edge_t, hs, a_s=None):
    """dW1 (3, Cc, n*2C) as k2_w1_kernel takes it: per (block, pass, o-tile)
    and unit, a recomputed (checked bit for bit against the data kernel's h
    at the same rows, ``hs``), or read from the data kernel's scratch
    ``a_s`` at wide E (the same bits), into its K-major image; A = g^T from
    the stage's rows shifted by the tap; the accumulators' runs of units (a
    CTA's chunk of units cut into runs of at most W1_RUN) summed in order."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    ot = 32 if two_c <= 32 else 64
    nsub = -(-t // UNIT)
    units = b * nsub
    tiles = n * -(-cc // PASS) * -(-two_c // ot)
    chunk = -(-units // min(max(1, SM_COUNT // tiles), units))
    run = -(-chunk // -(-chunk // W1_RUN))
    nch = -(-3 * ot // 64)
    n2 = n * two_c
    runs = -(-units // run)
    pw1 = np.zeros((runs, 3, cc, n2), np.float32)
    r = np.arange(64 * nch)
    j_r, o_r = r // ot, r % ot
    for i in range(n):
        for p in range(-(-cc // PASS)):
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
            cl, q = np.meshgrid(np.arange(PASS), np.arange(UNIT), indexing="ij")
            for o0 in range(0, two_c, ot):
                for r_i in range(runs):
                    acc = np.zeros((64 * nch, PASS), np.float32)
                    for k in range(r_i * run, min(units, (r_i + 1) * run)):
                        bb, sub = divmod(k, nsub)
                        s0 = sub * UNIT
                        img = np.zeros(2 * AIMG // 4, np.float32)
                        hi, lo = split(a[bb, sub].T)  # (136 c, 64 s)
                        kmajor_store(img, cl, q, hi)
                        kmajor_store(img[AIMG // 4:], cl, q, lo)
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
                            fa = split(av.astype(np.float32))
                            for cw, nn in ((0, 72), (72, 64)):
                                start = (cw // 8) * AGROUP + 256 * kk
                                fb = (desc_read(img, start, nn, 128, AGROUP),
                                      desc_read(img, AIMG + start, nn, 128, AGROUP))
                                for m in range(nch):
                                    rm = slice(64 * m, 64 * m + 64)
                                    add3s(acc[rm, cw:cw + nn], (fa[0][rm], fa[1][rm]), fb)
                    for rr in range(3 * ot):
                        o = o0 + o_r[rr]
                        if o < two_c:
                            width = min(PASS, cc - c0)
                            pw1[r_i, j_r[rr], c0:c0 + width, i * two_c + o] = acc[rr, :width]
    return ordered_sum(pw1)


def xdh_emulated(exc, dh_s, kx):
    """X^T dh as k2_xdh_kernel takes it: per CTA (128 columns of dh, 32 of X,
    one part of a batch row), X's K-major image built per step of 64 rows,
    A = dh^T from the raw stage; (B parts, K, n*Cc) partials, parts a batch
    row."""
    b, t, e = exc.shape
    n0 = dh_s.shape[-1]
    xcols, xks = -(-n0 // 128), -(-kx // 32)
    per_b = b * xcols * xks
    parts = min(max(1, -(-8 * SM_COUNT // per_b)), 65535 // b)
    prows = -(-(-(-t // parts)) // 64) * 64
    parts = -(-t // prows)
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


def k2_emulated(exc, w0, hbias, w1, g, edge0=None, edge_t=None):
    """The chain's backward as K2 takes it: the data kernel tile by tile,
    then k2_w1_kernel, k2_xdh_kernel and the ordered reduce of their
    partials."""
    b, t, e, n, cc, two_c = chain_dims(exc, w0, w1)
    dexc, dh_s, pb1, hs, a_s = k2_data_emulated(exc, w0, hbias, w1, g, edge0, edge_t)
    out = dict(exc=dexc, b1=ordered_sum(pb1.reshape(-1, n * two_c)))
    out["w1"] = w1_emulated(exc, w0, hbias, w1, g, edge0, edge_t, hs, a_s)
    pw0, parts = xdh_emulated(exc, dh_s, 3 * e + 3)
    out["w0"] = ordered_sum(pw0[:, :3 * e]).reshape(3, e, n * cc)
    per_b = pw0.reshape(b, parts, *pw0.shape[1:])
    dhb = np.stack([ordered_sum(per_b[bb, :, 3 * e]) for bb in range(b)])
    out["hbias"] = dhb if hbias.ndim == 2 else ordered_sum(pw0[:, 3 * e])
    if edge0 is not None:
        out.update(edge0=np.stack([ordered_sum(per_b[bb, :, 3 * e + 1]) for bb in range(b)]),
                   edge_t=np.stack([ordered_sum(per_b[bb, :, 3 * e + 2]) for bb in range(b)]))
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
K2_CASES = CASES + [(True, 1, 70, 10, 1, 138, 6), (False, 2, 530, 0, 1, 16, 72),
                    (True, 1, 300, 8, 6, 150, 136), (False, 2, 150, 0, 1, 48, 40)]
K2_IDS = IDS + ["split-E10-padded", "concat-two-otiles", "split-runs-of-two",
                "concat-E48-a-scratch"]


@pytest.mark.parametrize("split_form,b,t,e,n,cc,two_c", K2_CASES, ids=K2_IDS)
def test_k2_emulation_matches_plain(split_form, b, t, e, n, cc, two_c):
    """K2's kernels emulated at the widths the wrapper gives them, cut back:
    the data kernel, then k2_w1_kernel (lrelu(h) recomputed with the data
    kernel's bits, its K-major image, the tap shift on A) and k2_xdh_kernel
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
    got = k2_emulated(exc=ops["exc"].numpy(), **np32(padded))
    got = cond_chain._cut_grads({k: torch.from_numpy(v) for k, v in got.items()},
                                n, cc, two_c, cc_p, two_c_p)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_parity(got[k].numpy(), want[k].numpy(), f"d{k}")


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
