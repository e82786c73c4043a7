"""The tiling of the Hopper bf16 cond-chain kernels, emulated in numpy.

K1-bf16 (``csrc/cond_chain_bf16.cu``) and K2-bf16's data kernel
(``csrc/cond_chain_bwd_bf16.cu``) run on the card only. Their index
arithmetic and summation order are emulated here, step by step as the
kernels take them (``csrc/cond_chain_bf16.cuh`` describes the CTA), and held
to the plain bf16 versions (``cond_chain_plain``, ``cond_chain_bwd_plain``)
within one bf16 ulp, as ``chip_smoke.py`` holds the kernels on the card:

- a CTA owns 124 time rows; its two consumer warpgroups hold 64 rows of h
  each, from t0 + 62 w - 1, overlapping by two rows; the last tile is ragged;
- cond_0 is one product, h = X @ Wh with X = [exc taps | 1 | -[u == 0] |
  -[u == T-1]] and Wh = [W0; hbias; edge0; edge_t], K = 3E + 3 rounded up
  to 16 (chunks of 64 above 64), summed one k-slice of 16 at a time;
- columns of h go in passes of 136; as the K of the next product a pass is
  144 columns, the last 8 zero in A against W1's next columns (K1) or zero
  in both (K2's dexc);
- K1: E padded to a multiple of 8, or of 64 past 16; cond_0's X read from
  the exc rows t0 - 2 .. t0 + 125 a CTA stages (zero filled outside
  [0, T); boxes of 8 channels, or of 64 with TMA's 128-byte swizzle), tap j
  j rows down; CTAs over output chunks (every chunk in one CTA, or one
  each); P = a @ [W1_0 | W1_1 | W1_2] on chunks of 32 or 64 output columns,
  then out[t] = b1 + P_0[t-1] + P_1[t] + P_2[t+1] (route (a)), rounded once;
- K2's data kernel: a CTA per (run of consecutive tiles of one batch row,
  block, pass), at most 8 tiles a run; g's tap windows read rows
  t0 + 62 w - j, zero outside [0, T) (the TMA copy's zero fill); da in h's
  accumulator layout; the slope from the sign of h (lrelu(-0) = +0); each
  block's and pass's dexc the three taps' products of 64 rows, shifted and
  added, a partial summed over the blocks and passes in f32 in order and
  rounded once; at E <= 8 X^T dh (dW0, dhbias, the edges) of each tile's
  own rows, added in f32 tile by tile into a partial per (batch row, run);
  past E = 8 dh to the scratch;
- K2's weight grads: dW1 and db1 over units of 62 rows of g (two zero rows
  after them), with a of the rows t0 - 1 .. t0 + 62 (recomputed from exc at
  E <= 8, read from the data kernel's scratch past it) and a column of ones
  after the pass's columns (db1), tap j reading a from row j; the items
  (tile of 64 columns of g, unit) in equal runs over the card's SMs, a
  partial per segment of a tile; past E = 8 dW0, dhbias and the edges as
  X^T dh over the parts of each batch row; every kind of partial summed
  over its chunks in order and rounded once. k2b_w1_kernel's X at E = 8,
  read through descriptors from the exc rows TMA brings, is checked
  element by element.

Operands are dyadic where a slope must agree (cond_0's sums exact in any
order), as on the card. Numpy, and for the wide route's weight grads the
JAX package's Pallas kernel in interpret mode as the reference.
"""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.ops.pallas import cond_chain as jcc
from td_vc_gan_tpu_torch.ops.cuda import cond_chain

BF = torch.bfloat16
ULP_SHARE = 1e-2        # elements allowed beyond one bf16 ulp of the plain value
MAX_REL = 2.0 ** -7     # max|d| of max|plain|
TILE, OWN, ROWS, PASS = 124, 62, 64, 136
SMS = 132               # the card's SMs, which k2b_w1_kernel's chunks fill
SLOPE = np.float32(0.2)


def bf16(x):
    """f32 -> the nearest bf16 (ties to even), as f32 (finite x)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def np32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def assert_ulp(got, want, name):
    """Within one bf16 ulp of ``want`` for all but ULP_SHARE of the
    elements, and max|d| <= MAX_REL of max|want|."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, name
    d = np.abs(g - w)
    _, e = np.frexp(w)
    ulp = np.where(w == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))
    assert np.mean(d > ulp) <= ULP_SHARE, (name, np.mean(d > ulp))
    assert d.max() <= MAX_REL * max(np.abs(w).max(), 1e-30), (name, d.max(), np.abs(w).max())


def slices16(a, b, acc=None):
    """acc + a @ b, K summed one slice of 16 at a time in order (f32)."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32) if acc is None else acc
    for k in range(0, a.shape[1], 16):
        out = out + a[:, k:k + 16] @ b[k:k + 16]
    return out


def chain_ops(b, t, e, n, cc, two_c, seed, concat=False):
    """bf16 operands (as f32 arrays) of the split form, or of the concat
    form (exc = c, E = Cc, hbias shared, no edges): exc in 1/8 steps, W0
    and the biases in 1/256 steps, hbias offset by 1/4096, all rounded to
    bf16, so that h is exact in f32 in any order and never 0."""
    rng = np.random.default_rng(seed)

    def steps(shape, step, scale):
        return (np.round(scale * rng.standard_normal(shape) / step) * step).astype(np.float32)

    if concat:
        e = cc
    ops = dict(exc=steps((b, t, e), 1 / 8, 0.5), w0=steps((3, e, n * cc), 1 / 256, 0.1),
               hbias=steps((n * cc,) if concat else (b, n * cc), 1 / 256, 0.05)
               + np.float32(1 / 4096),
               w1=bf16((0.2 * rng.standard_normal((3, cc, n * two_c))).astype(np.float32)),
               b1=bf16((0.1 * rng.standard_normal((n * two_c,))).astype(np.float32)))
    if not concat:
        ops.update(edge0=steps((b, n * cc), 1 / 256, 0.05), edge_t=steps((b, n * cc), 1 / 256, 0.05))
    return {k: bf16(v) for k, v in ops.items()}


def wg_rows(t):
    """Every consumer warpgroup of every time tile: (tile, w, u0), its h rows
    u0 + q for q < 64."""
    return [(tile, w, tile * TILE + OWN * w - 1)
            for tile in range(-(-t // TILE)) for w in (0, 1)]


def geo(e, cc):
    """(passes, K of the h product rounded as the kernels round it)."""
    k16 = -(-(3 * e + 3) // 16) * 16
    kh = k16 if k16 <= 64 else -(-k16 // 64) * 64
    return -(-cc // PASS), kh


def x_rows(ops, b, u, kh):
    """X[u] (rows u, any integers): exc taps, 1, -[u == 0], -[u == T-1],
    zeros to K = kh."""
    exc = ops["exc"][b]
    t, e = exc.shape
    x = np.zeros((len(u), kh), np.float32)
    for j in range(3):
        r = u + j - 1
        ok = (r >= 0) & (r < t)
        x[ok, j * e:(j + 1) * e] = exc[r[ok]]
    x[:, 3 * e] = 1
    x[:, 3 * e + 1] = -(u == 0).astype(np.float32)
    x[:, 3 * e + 2] = -(u == t - 1).astype(np.float32)
    return x


def wh_block(ops, b, i, p, kh):
    """Wh of block i, pass p (kh x 136): W0's taps, hbias, edges; zero beyond Cc."""
    e = ops["exc"].shape[2]
    cc = ops["w1"].shape[1]
    c = np.arange(p * PASS, (p + 1) * PASS)
    ok = c < cc
    col = i * cc + c[ok]
    w = np.zeros((kh, PASS), np.float32)
    w[:3 * e, ok] = ops["w0"][:, :, col].reshape(3 * e, -1)
    hb = ops["hbias"]
    w[3 * e, ok] = (hb[b] if hb.ndim == 2 else hb)[col]
    if "edge0" in ops:
        w[3 * e + 1, ok] = ops["edge0"][b, col]
        w[3 * e + 2, ok] = ops["edge_t"][b, col]
    return w


def act(ops, b, u, i, p, kh):
    """lrelu(h) of the rows u for block i, pass p (f32, zero outside [0, T)
    and beyond Cc, +0 where h is -0)."""
    t = ops["exc"].shape[1]
    cc = ops["w1"].shape[1]
    h = slices16(x_rows(ops, b, u, kh), wh_block(ops, b, i, p, kh))
    a = np.where(h >= 0, h + np.float32(0), SLOPE * h)
    ok = ((u >= 0) & (u < t))[:, None] & (np.arange(p * PASS, (p + 1) * PASS) < cc)[None]
    return np.where(ok, a, np.float32(0))


def k1_plan(bsz, t, e, cc, two_c, sms=SMS):
    """K1-bf16's grid over output chunks (fwd_plan): (W, chunks, chunks a
    CTA); W = 32 where 2C <= 32 or Cc takes several passes. A CTA takes
    every chunk (h once a tile) where the tiles fill the SMs and Cc is one
    pass, else one chunk (h per chunk)."""
    width = 32 if two_c <= 32 or cc > PASS else 64
    noc = -(-two_c // width)
    split = cc > PASS or -(-t // TILE) * bsz < sms
    return width, noc, 1 if split else noc


def x_tile(exc, b, t0):
    """The exc boxes a CTA stages: rows t0 - 2 .. t0 + 125 (128), zero
    outside [0, T) (TMA's fill), every channel."""
    t = exc.shape[1]
    rows = t0 - 2 + np.arange(128)
    ok = (rows >= 0) & (rows < t)
    return np.where(ok[:, None], exc[b, np.clip(rows, 0, t - 1)], 0).astype(np.float32)


def swizzled(box):
    """A box of 128-byte rows (64 bf16 channels) as TMA's 128-byte swizzle
    lays it in shared memory: 16-byte piece p of row R at piece p ^ R % 8."""
    out = np.empty_like(box)
    for r in range(box.shape[0]):
        for piece in range(8):
            dst = piece ^ (r % 8)
            out[r, 8 * dst:8 * dst + 8] = box[r, 8 * piece:8 * piece + 8]
    return out


def x_from_tile(tile, w, u0, t, k16):
    """X of warpgroup w's 64 rows (u0 + q) as K1-bf16's ldmatrix reads it
    from the staged boxes, tap j at the box row R = 62 w + q + j. E <= 16:
    group g < 3E/8 of 8 k is channels 8 (g % nbx) .. of tap j = g // nbx.
    E > 16 (a multiple of 64): chunk kc of 64 k is tap kc // (E/64)'s box of
    channels 64 (kc % (E/64)) .., swizzled, its piece p of row R read at
    p ^ R % 8. Then the group [1, -[u == 0], -[u == T-1], 0 ...] made in
    registers, zeros past it."""
    e = tile.shape[1]
    nbx = e // 8
    q = np.arange(ROWS)
    u = u0 + q
    x = np.zeros((ROWS, k16), np.float32)
    boxes = [swizzled(tile[:, c:c + 64]) for c in range(0, e, 64)] if e > 16 else None
    for g in range(k16 // 8):
        if g < 3 * nbx and boxes is None:
            j, eb = divmod(g, nbx)
            x[:, 8 * g:8 * g + 8] = tile[OWN * w + q + j, 8 * eb:8 * eb + 8]
        elif g < 3 * nbx:
            kc, piece = divmod(g, 8)
            j, m = divmod(kc, e // 64)
            rr = OWN * w + q + j
            cols = 8 * (piece ^ (rr % 8))[:, None] + np.arange(8)[None]
            x[:, 8 * g:8 * g + 8] = boxes[m][rr[:, None], cols]
        elif g == 3 * nbx:
            x[:, 8 * g] = 1
            x[:, 8 * g + 1] = -(u == 0).astype(np.float32)
            x[:, 8 * g + 2] = -(u == t - 1).astype(np.float32)
    return x


def k1_emulated(ops, cpc=None):
    """K1-bf16's arithmetic as its CTAs take it: (B, T, n*2C), f32 values of
    bf16. E padded to a multiple of 8, or of 64 past 16 (the wrapper's
    _padded_e, _pad_exc); CTAs over
    (time tile, batch row, group of ``cpc`` output chunks, by default
    k1_plan's); X read from each CTA's staged exc boxes."""
    cc = ops["w1"].shape[1]
    n = ops["w0"].shape[2] // cc
    two_c = ops["w1"].shape[2] // n
    e = ops["exc"].shape[2]
    exc, w0 = (x.numpy() for x in cond_chain._pad_exc(
        torch.from_numpy(ops["exc"]), torch.from_numpy(ops["w0"]),
        cond_chain._padded_e("fwd_bf16", e)))
    ops = dict(ops, exc=exc, w0=w0)
    bsz, t, e8 = exc.shape
    npass = -(-cc // PASS)
    k16 = -(-(3 * e8 + 3) // 16) * 16
    width, noc, plan_cpc = k1_plan(bsz, t, e8, cc, two_c)
    cpc = cpc or plan_cpc
    cc8 = -(-cc // 8) * 8
    # W1 transposed and padded, (n, 3, 2C, Cc8), read in atoms of 64 columns
    # of c (the tensor map's zero fill beyond Cc8 and 2C)
    w1t = np.zeros((n, 3, two_c, cc8 + PASS + 64), np.float32)
    w1t[..., :cc] = ops["w1"].reshape(3, cc, n, two_c).transpose(2, 0, 3, 1)
    out = np.zeros((bsz, t, n * two_c), np.float32)
    written = np.zeros((bsz, -(-t // TILE), noc), int)
    for b in range(bsz):
        for tix in range(-(-t // TILE)):
            tile = x_tile(exc, b, tix * TILE)
            for z in range(noc // cpc):
                chunks = range(z * cpc, (z + 1) * cpc)
                written[b, tix, list(chunks)] += 1
                for w in (0, 1):
                    u0 = tix * TILE + OWN * w - 1
                    u = u0 + np.arange(ROWS)
                    x = x_from_tile(tile, w, u0, t, k16)
                    np.testing.assert_array_equal(x, x_rows(ops, b, u, k16))
                    for i in range(n):
                        a = []
                        for p in range(npass):
                            h = slices16(x, wh_block(ops, b, i, p, k16))
                            ok = ((u >= 0) & (u < t))[:, None] & \
                                (np.arange(p * PASS, (p + 1) * PASS) < cc)[None]
                            a.append(bf16(np.where(ok, np.where(h >= 0, h + np.float32(0),
                                                                SLOPE * h), np.float32(0))))
                        for oc in chunks:
                            o = oc * width + np.arange(width)
                            p_acc = np.zeros((ROWS, 3 * width), np.float32)
                            for p in range(npass):
                                ap = np.concatenate([a[p], np.zeros((ROWS, 8), np.float32)], 1)
                                # B: the three taps' W x 144 columns of the pass, the
                                # last 8 the next columns of W1 (against zeros in A)
                                bt = np.zeros((144, 3 * width), np.float32)
                                for j in range(3):
                                    ok = o < two_c
                                    bt[:, j * width + np.arange(width)[ok]] = \
                                        w1t[i, j, o[ok], p * PASS:p * PASS + 144].T
                                p_acc = slices16(ap, bt, p_acc)
                            # out = b1 + P_0[r] + P_1[r + 1] + P_2[r + 2]
                            r = np.arange(OWN)
                            tt = u0 + 1 + r
                            okr, oko = tt < t, o < two_c
                            col = i * two_c + o[oko]
                            s = ((ops["b1"][col][None] + p_acc[r][:, :width][:, oko])
                                 + p_acc[r + 1][:, width:2 * width][:, oko]) \
                                + p_acc[r + 2][:, 2 * width:][:, oko]
                            out[b, tt[okr][:, None], col[None]] = bf16(s[okr])
    assert (written == 1).all()
    return out


def w1_plan(bsz, t, n, npass, two_c):
    """k2b_w1_kernel's work (make_plan): tiles of (block, pass, 64 columns
    of g) times units of 62 rows, the items tile-major in equal runs over one
    wave of SMS CTAs; a tile's segments (one a CTA) write partial slots 0,
    1, ..: (tiles, units a batch row, units a tile, items a CTA, CTAs,
    slots)."""
    tiles = n * npass * -(-two_c // 64)
    nsub = -(-t // OWN)
    units = bsz * nsub
    per_cta = -(-(tiles * units) // SMS)
    ctas = -(-(tiles * units) // per_cta)
    slots = max(((tau + 1) * units - 1) // per_cta - tau * units // per_cta + 1
                for tau in range(tiles))
    return tiles, nsub, units, per_cta, ctas, slots


def w1_segments(plan):
    """The segments of k2b_w1_kernel's CTAs in launch order: (CTA, tile,
    slot, units of the tile)."""
    tiles, _, units, per_cta, ctas, _ = plan
    out = []
    for cta in range(ctas):
        x0, x1 = cta * per_cta, min(tiles * units, (cta + 1) * per_cta)
        for tau in range(x0 // units, (x1 - 1) // units + 1):
            k0, k1 = max(x0, tau * units), min(x1, (tau + 1) * units)
            out.append((cta, tau, cta - tau * units // per_cta,
                        list(range(k0 - tau * units, k1 - tau * units))))
    return out


def xdh_plan(bsz, t, e, n0):
    """k2b_xdh_kernel's parts of a batch row (make_plan): at least 264 CTAs
    of (256 columns of dh, 64 rows of X^T): (parts, rows a part)."""
    per_b = bsz * -(-n0 // 256) * -(-(3 * e + 3) // 64)
    parts = max(1, -(-264 // per_b))
    prows = -(-(-(-t // parts)) // 64) * 64
    return -(-t // prows), prows


def in_order(parts):
    """The partials summed in f32 in order, from 0 (k2b_reduce_kernel)."""
    tot = np.zeros_like(parts[0])
    for x in parts:
        tot = tot + x
    return tot


def run_plan(bsz, t, n, npass, sms=None):
    """The data kernel's runs (make_plan): a CTA walks a run of consecutive
    time tiles of one batch row for one block and pass, at most 8 tiles (16
    units of 62 rows, the most a partial of X^T dh sums), in more runs while
    the CTAs would not fill two waves of SMS: (tiles a run, runs a batch row)."""
    sms = SMS if sms is None else sms
    ntiles = -(-t // TILE)
    runs = -(-ntiles // 8)
    while bsz * n * npass * runs < 2 * sms and runs < ntiles:
        runs += 1
    run = -(-ntiles // runs)
    return run, -(-ntiles // run)


def k2_emulated(ops, g):
    """K2-bf16's arithmetic as its kernels take it (the data kernel's runs of
    tiles, its dexc partials and, at E <= 8, its X^T dh partials; past E = 8
    the dh scratch and k2b_xdh_kernel's parts; k2b_w1_kernel's units and
    chunks; the ordered reductions): the gradients' dict, f32 values of
    bf16."""
    bsz, t, e = ops["exc"].shape
    cc = ops["w1"].shape[1]
    n = ops["w0"].shape[2] // cc
    two_c = ops["w1"].shape[2] // n
    npass, kh = geo(e, cc)
    nec = -(-e // 8)
    n0 = n * cc
    kx = 3 * e + 3
    narrow = e <= 8
    run, nruns = run_plan(bsz, t, n, npass)
    dh_s = np.zeros((bsz, t, n0), np.float32)
    a_s = np.zeros((bsz, t, n0), np.float32)
    pdexc = np.zeros((n * npass, bsz, t, e), np.float32)
    pw0 = np.zeros((bsz * nruns, kx, n0), np.float32)
    tiles = -(-t // TILE)
    for b in range(bsz):
        for ip in range(n * npass):
            i, p = divmod(ip, npass)
            c = p * PASS + np.arange(PASS)
            okc = c < cc
            cols = i * cc + c[okc]
            for rn in range(nruns):
                xacc = None
                for tile in range(rn * run, min(tiles, (rn + 1) * run)):
                    dh_w, x_w = [], []
                    for w in (0, 1):
                        u0 = tile * TILE + OWN * w - 1
                        u = u0 + np.arange(ROWS)
                        valid = (u >= 0) & (u < t)
                        own = (np.arange(ROWS) >= 1) & (np.arange(ROWS) <= OWN) & (u < t)
                        a = bf16(act(ops, b, u, i, p, kh))
                        # da: tap j, chunks of 64 columns of g, slices of 16
                        da = np.zeros((ROWS, PASS), np.float32)
                        for j in range(3):
                            r = u + 1 - j
                            ok = (r >= 0) & (r < t)
                            gj = np.zeros((ROWS, -(-two_c // 16) * 16), np.float32)
                            gj[ok, :two_c] = g[b, r[ok], i * two_c:(i + 1) * two_c]
                            wj = np.zeros((gj.shape[1], PASS), np.float32)
                            wj[:two_c, okc] = ops["w1"][j, c[okc], i * two_c:(i + 1) * two_c].T
                            da = slices16(gj, wj, da)
                        neg = np.signbit(a)
                        dh = np.where(valid[:, None], bf16(np.where(neg, SLOPE * da, da)), 0)
                        if not narrow:
                            rows = u[own]
                            dh_s[b, rows[:, None], cols[None]] = dh[own][:, okc]
                            a_s[b, rows[:, None], cols[None]] = a[own][:, okc]
                        # X^T dh's operands: the window's dh and X, X zero in the
                        # halo rows (q = 0, 63), which other windows own
                        x = x_rows(ops, b, u, kx)
                        x[[0, ROWS - 1]] = 0
                        dh_w.append(dh)
                        x_w.append(x)
                        # this block's and pass's dexc: E in chunks of 8, the three
                        # taps' products P_j of all 64 rows (K = 144), then
                        # dexc[r] = (P_0[r + 2] + P_1[r + 1]) + P_2[r]
                        dh144 = np.concatenate([dh, np.zeros((ROWS, 8), np.float32)], 1)
                        w0x = np.zeros((3, 144, nec * 8), np.float32)
                        w0x[:, :PASS][:, okc, :e] = ops["w0"][:, :, cols].transpose(0, 2, 1)
                        dx = np.zeros((OWN, nec * 8), np.float32)
                        for ec in range(nec):
                            pj = [slices16(dh144, w0x[j][:, ec * 8:(ec + 1) * 8]) for j in range(3)]
                            dx[:, ec * 8:(ec + 1) * 8] = (pj[0][2:] + pj[1][1:-1]) + pj[2][:-2]
                        tt = u0 + 1 + np.arange(OWN)
                        ok = tt < t
                        pdexc[ip, b, tt[ok]] = dx[ok][:, :e]
                    if narrow:
                        # X^T dh of the tile's rows (window 0 then 1, 16 rows a
                        # slice) added to the run's sum
                        tsum = slices16(x_w[1].T, dh_w[1], slices16(x_w[0].T, dh_w[0]))
                        xacc = tsum if xacc is None else xacc + tsum
                if narrow:
                    pw0[b * nruns + rn][:, cols] = xacc[:, okc]
    dexc = bf16(in_order(pdexc))
    # dW1 and db1 (k2b_w1_kernel): a unit is a batch row's 62 rows t0 + r of g
    # (zero outside [0, T), then two zero rows); a of the rows t0 - 1 + q,
    # q < 64 (then 8 zero rows; recomputed at E <= 8, past it read from the
    # data kernel's scratch), with db1's column of ones after the pass's
    # columns; tap j's B is a from row j; each segment of a tile's units sums
    # in f32, slice by slice, unit by unit, into its slot
    plan = w1_plan(bsz, t, n, npass, two_c)
    _, nsub, _, _, _, slots = plan
    notiles = -(-two_c // 64)
    pw1 = np.zeros((slots, 3, cc, n * two_c), np.float32)
    pb1 = np.zeros((slots, n * two_c), np.float32)
    for _, tau, slot, ks in w1_segments(plan):
        i, p = divmod(tau // notiles, npass)
        o = (tau % notiles) * 64 + np.arange(64)
        oko = o < two_c
        col = i * two_c + o[oko]
        c0, cend = p * PASS, min(cc - p * PASS, PASS)
        acc = [None] * 3
        for k in ks:
            b, t0 = k // nsub, (k % nsub) * OWN
            u = t0 - 1 + np.arange(ROWS)
            r = t0 + np.arange(ROWS)
            okr = (np.arange(ROWS) < OWN) & (r < t)
            gt = np.zeros((ROWS, 64), np.float32)
            gt[np.ix_(okr, oko)] = g[b, r[okr]][:, col]
            a = np.zeros((ROWS + 8, PASS + 8), np.float32)
            if narrow:
                a[:ROWS, :PASS] = bf16(act(ops, b, u, i, p, kh))
            else:
                ok = (u >= 0) & (u < t)
                a[np.ix_(np.flatnonzero(ok), np.arange(cend))] = \
                    a_s[b, u[ok]][:, i * cc + c0:i * cc + c0 + cend]
            a[:, PASS] = 1
            for j in range(3):
                acc[j] = slices16(gt.T, a[j:j + ROWS], acc[j])
        for j in range(3):
            pw1[slot, j, c0:c0 + cend][:, col] = acc[j][oko, :cend].T
        if p == 0:
            pb1[slot, col] = acc[1][oko, PASS]
    # past E = 8, dW0, dhbias and the edges (k2b_xdh_kernel): X^T dh over the
    # rows of each part of each batch row, 64 rows a step, X zero past the part
    parts = nruns
    if not narrow:
        parts, prows = xdh_plan(bsz, t, e, n0)
        pw0 = np.zeros((bsz * parts, kx, n0), np.float32)
        for b in range(bsz):
            for part in range(parts):
                r0, r1 = part * prows, min(t, (part + 1) * prows)
                acc = None
                for t0 in range(r0, r1, ROWS):
                    u = t0 + np.arange(ROWS)
                    ok = u < r1
                    x = np.where(ok[:, None], x_rows(ops, b, u, kx), np.float32(0))
                    d = np.zeros((ROWS, n0), np.float32)
                    d[ok] = dh_s[b, u[ok]]
                    acc = slices16(x.T, d, acc)
                pw0[b * parts + part] = acc
    per_b = pw0.reshape(bsz, parts, kx, n0)
    out = dict(exc=dexc, w0=bf16(in_order(pw0[:, :3 * e]).reshape(3, e, n0)),
               w1=bf16(in_order(pw1)), b1=bf16(in_order(pb1)))
    if ops["hbias"].ndim == 2:
        out["hbias"] = bf16(np.stack([in_order(per_b[b, :, 3 * e]) for b in range(bsz)]))
    else:
        out["hbias"] = bf16(in_order(pw0[:, 3 * e]))
    if "edge0" in ops:
        out.update(edge0=np.stack([in_order(per_b[b, :, 3 * e + 1]) for b in range(bsz)]),
                   edge_t=np.stack([in_order(per_b[b, :, 3 * e + 2]) for b in range(bsz)]))
    return out


def torch_ops(ops):
    return {k: torch.from_numpy(v).to(BF) for k, v in ops.items()}


# (label, B, T, E, n, Cc, 2C, concat): the decoder's Cc = 136 and E = 8 at a
# ragged T (two tiles, the second 26 rows), E = 6 and 10 (K = 21 and 33: one
# and three k-slices), a wide Cc (three passes, the last of 28 columns, Cc
# not a multiple of 8), 2C = 72 (K1: a second, ragged 64-column chunk; K2: a
# one-slice chunk of g), and the concat form (K = 3 Cc + 3 in two chunks of 64)
CASES = [("decoder", 2, 150, 8, 2, 136, 32, False),
         ("e6", 1, 130, 6, 2, 136, 32, False),
         ("e10", 1, 130, 10, 2, 136, 64, False),
         ("wide-cc", 1, 70, 8, 2, 300, 32, False),
         ("2c72", 1, 70, 8, 2, 136, 72, False),
         ("concat", 2, 70, 24, 2, 24, 16, True)]


# K1-bf16's cases add T shorter than one tile with 2C = 256 (four output
# chunks), E = 16 (K = 51: one chunk of W0's image, two exc boxes kept for
# the CTA) on two tiles, and the options' bottleneck, the concat form at
# Cc = E = 256 (two passes; K = 771 in 13 chunks, the exc boxes streamed with
# them), at B = 1
K1_CASES = CASES + [("t28-2c256", 2, 28, 8, 2, 136, 256, False),
                    ("e16", 1, 130, 16, 1, 136, 64, False),
                    ("bottleneck-256", 1, 28, 256, 1, 256, 256, True)]


@pytest.mark.parametrize("case", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_bf16_tiles_emulated(case):
    _, b, t, e, n, cc, two_c, concat = case
    ops = chain_ops(b, t, e, n, cc, two_c, seed=cc + two_c + e, concat=concat)
    want = cond_chain.cond_chain_plain(**torch_ops(ops))
    assert_ulp(k1_emulated(ops), want, "out")


def test_k1_bf16_grid_over_output_chunks():
    """fwd_plan's choice: at the bottleneck (16 x 28, Cc = E = 128 and 256,
    2C = 256: 16 tiles; at 256 two passes) a CTA per chunk; on the
    conversion's first stage (16 x 2240, 2C = 256: 304 tiles) every chunk in
    one CTA, h once a tile. Both groupings give the same output, each chunk
    written by one CTA."""
    assert k1_plan(16, 28, 128, 128, 256) == (64, 4, 1)
    assert k1_plan(16, 28, 256, 256, 256) == (32, 8, 1)
    assert k1_plan(16, 2240, 8, 136, 256) == (64, 4, 4)
    ops = chain_ops(1, 130, 8, 2, 136, 256, seed=3)
    np.testing.assert_array_equal(k1_emulated(ops, cpc=1), k1_emulated(ops, cpc=4))


def test_padding_widths_for_k1_bf16():
    """E to a multiple of 8 up to 16, else of 64; Cc and 2C to multiples of 4."""
    assert [cond_chain._padded_e("fwd_bf16", e) for e in (6, 8, 10, 16, 24, 256, 600)] == \
        [8, 8, 16, 16, 64, 256, 640]
    assert cond_chain._padded_e("fwd", 6) == 6 and cond_chain._padded_e("bwd_bf16", 6) == 6
    assert cond_chain._padded_widths("fwd_bf16", 11, 6) == (12, 8)


def test_padding_e_to_a_multiple_of_8_is_exact():
    """K1-bf16 runs E at the next multiple of 8, exc and W0 padded with zero
    channels (``_pad_exc``): the plain chain on the padded operands gives
    the same bits."""
    ops = torch_ops(chain_ops(2, 40, 10, 3, 20, 12, seed=7))
    want = cond_chain.cond_chain_plain(**ops)
    exc, w0 = cond_chain._pad_exc(ops["exc"], ops["w0"], 16)
    assert exc.shape == (2, 40, 16) and w0.shape == (3, 16, 60)
    assert torch.equal(cond_chain.cond_chain_plain(**dict(ops, exc=exc, w0=w0)), want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k2_bf16_tiles_emulated(case):
    _, b, t, e, n, cc, two_c, concat = case
    ops = chain_ops(b, t, e, n, cc, two_c, seed=cc + two_c + e + 1, concat=concat)
    g = bf16(np.random.default_rng(cc + t).standard_normal((b, t, n * two_c)).astype(np.float32))
    tops = {k: v for k, v in torch_ops(ops).items() if k != "b1"}
    want = cond_chain.cond_chain_bwd_plain(g=torch.from_numpy(g).to(BF), **tops)
    got = k2_emulated(ops, g)
    assert set(got) == set(want)
    for k in want:
        assert_ulp(got[k], want[k], k)


def test_k2_bf16_weight_grads_in_chunks_of_units(monkeypatch):
    """k2b_w1_kernel's segments on a card of 5 SMs: 3 tiles of 8 units of 62
    rows in runs of 5 items a CTA, so that CTAs cross from one tile (and
    batch row) into the next mid-run and tiles take 2 or 3 partial slots
    (the reduce sums 3, the missing ones zero); the partials summed in
    order. The plans at the step's largest and smallest calls (B = 128) fill
    the card's 132 SMs."""
    assert w1_plan(128, 8960, 9, 1, 32) == (9, 145, 18560, 1266, 132, 16)
    assert w1_plan(128, 280, 9, 1, 256) == (36, 5, 640, 175, 132, 5)
    monkeypatch.setattr(sys.modules[__name__], "SMS", 5)
    _, b, t, e, n, cc, two_c, _ = CASES[0]
    assert w1_plan(2, 200, 3, 1, two_c) == (3, 4, 8, 5, 5, 3)
    assert [(cta, tau, slot, len(ks)) for cta, tau, slot, ks in
            w1_segments(w1_plan(2, 200, 3, 1, two_c))] == [
        (0, 0, 0, 5), (1, 0, 1, 3), (1, 1, 0, 2), (2, 1, 1, 5), (3, 1, 2, 1), (3, 2, 0, 4),
        (4, 2, 1, 4)]
    ops = chain_ops(2, 200, e, 3, cc, two_c, seed=11)
    g = bf16(np.random.default_rng(12).standard_normal((2, 200, 3 * two_c)).astype(np.float32))
    tops = {k: v for k, v in torch_ops(ops).items() if k != "b1"}
    want = cond_chain.cond_chain_bwd_plain(g=torch.from_numpy(g).to(BF), **tops)
    got = k2_emulated(ops, g)
    for k in want:
        assert_ulp(got[k], want[k], k)


def test_k2_bf16_runs_of_tiles_to_a_ragged_row_end(monkeypatch):
    """The data kernel's runs on a card of 1 SM: two runs of 8 tiles a batch
    row (T = 1900: 16 tiles, the last of 40 rows), so that each X^T dh
    partial sums its run's 16 units of 62 rows, the most it may, and the
    second run ends at the batch row's ragged end; the runs the plan takes
    at the step's largest and smallest calls and at the bottleneck."""
    assert run_plan(128, 8960, 9, 1) == (8, 10)
    assert run_plan(64, 280, 9, 1) == (3, 1)
    assert run_plan(16, 224, 1, 1) == (1, 2)
    monkeypatch.setattr(sys.modules[__name__], "SMS", 1)
    assert run_plan(2, 1900, 1, 1) == (8, 2)
    ops = chain_ops(2, 1900, 8, 1, 136, 16, seed=21)
    g = bf16(np.random.default_rng(22).standard_normal((2, 1900, 16)).astype(np.float32))
    tops = {k: v for k, v in torch_ops(ops).items() if k != "b1"}
    want = cond_chain.cond_chain_bwd_plain(g=torch.from_numpy(g).to(BF), **tops)
    got = k2_emulated(ops, g)
    for k in want:
        assert_ulp(got[k], want[k], k)


def test_padding_2c_to_a_multiple_of_8_is_exact():
    """K2-bf16 runs 2C = 4 mod 8 at the next multiple of 8, g and W1 padded
    with zero columns per block (``_pad_blocks``): the plain backward on the
    padded operands gives the same gradients, dW1 and db1 cut back."""
    ops = torch_ops(chain_ops(2, 40, 8, 3, 20, 12, seed=5))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 40, 36))
                         .astype(np.float32)).to(BF)
    args = {k: v for k, v in ops.items() if k != "b1"}
    want = cond_chain.cond_chain_bwd_plain(g=g, **args)
    padded = cond_chain.cond_chain_bwd_plain(
        g=cond_chain._pad_blocks(g, 3, 12, 16),
        **dict(args, w1=cond_chain._pad_blocks(args["w1"], 3, 12, 16)))
    assert padded["w1"].shape == (3, 20, 48) and padded["b1"].shape == (48,)
    cut = dict(padded, w1=padded["w1"].reshape(3, 20, 3, 16)[..., :12].reshape(3, 20, 36),
               b1=padded["b1"].reshape(3, 16)[:, :12].reshape(36))
    for k in want:
        assert torch.equal(cut[k], want[k]), k
    assert not cond_chain._pad_blocks(g, 3, 12, 16).reshape(2, 40, 3, 16)[..., 12:].any()


def test_bf16_libraries_are_keyed_on_the_hopper_header(tmp_path):
    """Both bf16 libraries include csrc/hopper_bf16.cuh (through
    cond_chain_bf16.cuh), and so do both f32 ones (through
    cond_chain_f32.cuh, their Hopper kernels): editing it rebuilds all four;
    editing cond_chain_bf16.cuh rebuilds the bf16 ones only."""
    for src in (*cond_chain.SOURCES, *cond_chain.BF16_SOURCES,
                *cond_chain.SOURCES[0].parent.glob("*.cuh")):
        shutil.copy(src, tmp_path / src.name)
    bf = [tmp_path / s.name for s in cond_chain.BF16_SOURCES]
    f32 = [tmp_path / s.name for s in cond_chain.SOURCES]
    for src in (*bf, *f32):
        assert "hopper_bf16.cuh" in {p.name for p in cond_chain._sources_of(src)}
    before = [cond_chain._lib_path(x) for x in (*bf, *f32)]
    header = tmp_path / "hopper_bf16.cuh"
    header.write_text(header.read_text() + "\n")
    after = [cond_chain._lib_path(x) for x in (*bf, *f32)]
    assert all(a != b for a, b in zip(after, before))
    header = tmp_path / "cond_chain_bf16.cuh"
    header.write_text(header.read_text() + "\n")
    again = [cond_chain._lib_path(x) for x in (*bf, *f32)]
    assert again[0] != after[0] and again[1] != after[1] and again[2:] == after[2:]


def test_k2_bf16_wide_weight_grads_from_the_scratch_against_jax():
    """Past E = 8 (the concat form at Cc = E = 144: two passes, K = 435 in
    seven chunks) k2b_w1_kernel recomputes nothing: a is the data kernel's
    bf16(lrelu(h)) of its own rows, read from the scratch. dW1 and db1 of
    that route (emulated) against the JAX package's ``_chain_bwd``, the
    Pallas kernel in interpret mode on the same bf16 operands (f32 sums cast
    once), within one bf16 ulp but for ULP_SHARE."""
    ops = chain_ops(1, 96, 24, 2, 144, 16, seed=31, concat=True)
    g = bf16(np.random.default_rng(32).standard_normal((1, 96, 32)).astype(np.float32))
    got = k2_emulated(ops, g)
    jops = [jnp.asarray(ops[k], jnp.bfloat16) for k in ("exc", "w0", "hbias", "w1", "b1")]
    _, vjp = jax.vjp(lambda *a: jcc.film_cond_chain(*a, interpret=True)[..., :32], *jops)
    *_, dw1, db1 = vjp(jnp.asarray(g, jnp.bfloat16))
    assert_ulp(got["w1"], np.asarray(dw1, np.float32), "w1")
    assert_ulp(got["b1"], np.asarray(db1, np.float32), "b1")


def test_k2b_w1_x_from_the_exc_rows():
    """k2b_w1_kernel's X at E = 8 without a copy: the h product's A is read
    through K-major descriptors (8-row groups 128 bytes apart, the k-slice's
    two 8-column halves LBO bytes apart) from the unit's exc rows t0 - 2 ..
    t0 + 63 as TMA lays them (16 bytes a row, zeros outside [0, T)) and, for
    k = 24 .. 31, from one of six chunks of 64 rows of (1, -[u == 0],
    -[u == T-1], 0 ..) written once: slice 0 from the rows' start with
    LBO = 16 (tap 1 is tap 0 a row on), slice 1 from 32 bytes in with LBO
    reaching the chunk. The 64 x 32 operand is X of the unit's rows t0 - 1 ..
    t0 + 62 (x_rows) at every unit of a batch row, at T = 150 and at
    T = 125 = 1 mod 62, where the unit before the last holds u = T-1 in its
    halo row."""
    for t in (150, 125):
        ops = chain_ops(1, t, 8, 1, 8, 8, seed=41)
        nsub = -(-t // OWN)
        q_last = t - (nsub - 1) * OWN
        for t0 in range(0, nsub * OWN, OWN):
            rows = t0 - 2 + np.arange(66)
            ok = (rows >= 0) & (rows < t)
            mem = np.zeros(8192, np.float32)  # one bf16 element a slot of 2 bytes
            mem[:66 * 8] = np.where(ok[:, None], ops["exc"][0, np.clip(rows, 0, t - 1)], 0).ravel()
            kind = (t0 == 0) + (2 if t0 + OWN >= t else 4 if t0 + OWN == t - 1 else 0)
            base = 2048  # the kinds' byte offset, past the rows
            for kd in range(6):
                q = np.arange(64)
                first = (kd & 1) * (q == 1)
                last = (kd >> 1 == 1) * (q == q_last) + (kd >> 1 == 2) * (q == 63)
                chunk = np.stack([np.ones(64), -1.0 * first, -1.0 * last] + [np.zeros(64)] * 5, 1)
                mem[(base + kd * 1024) // 2:(base + kd * 1024) // 2 + 64 * 8] = chunk.ravel()

            def operand(start, lbo, sbo=128):
                r, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
                off = start + (r // 8) * sbo + (k // 8) * lbo + (r % 8) * 16 + (k % 8) * 2
                return mem[off // 2]

            got = np.concatenate([operand(0, 16), operand(32, base + kind * 1024 - 32)], 1)
            u = t0 - 1 + np.arange(64)
            np.testing.assert_array_equal(got[:, :27], x_rows(ops, 0, u, 27))
