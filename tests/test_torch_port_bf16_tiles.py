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
- K1: P = a @ [W1_0 | W1_1 | W1_2] on chunks of 32 or 64 output columns,
  then out[t] = b1 + P_0[t-1] + P_1[t] + P_2[t+1] (route (a)), rounded once;
- K2's data kernel: g's tap windows read rows t0 + 62 w - j, zero outside
  [0, T) (the TMA copy's zero fill); da in h's accumulator layout; the
  slope from the sign of bf16(lrelu(h)) (with lrelu(-0) = +0, the sign of
  h); dexc summed over the blocks and passes in f32 and rounded once; dh to
  the scratch;
- K2's weight grads: dW1 and db1 over units of 62 rows of g (two zero rows
  after them), with a recomputed from exc for the rows t0 - 1 .. t0 + 62
  and tap j reading a from row j, in chunks of units; dW0, dhbias and the
  edges as X^T dh over the parts of each batch row; every kind of partial
  summed over its chunks in order and rounded once.

Operands are dyadic where a slope must agree (cond_0's sums exact in any
order), as on the card. Numpy only, no JAX compile.
"""

import shutil
import sys

import numpy as np
import pytest
import torch

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


def k1_emulated(ops):
    """K1-bf16's arithmetic as its CTAs take it: (B, T, n*2C), f32 values of bf16."""
    bsz, t, e = ops["exc"].shape
    cc = ops["w1"].shape[1]
    n = ops["w0"].shape[2] // cc
    two_c = ops["w1"].shape[2] // n
    npass, kh = geo(e, cc)
    width = 32 if two_c <= 32 else 64
    cc8 = -(-cc // 8) * 8
    # W1 transposed and padded, (n, 3, 2C, Cc8), read in atoms of 64 columns
    # of c (the tensor map's zero fill beyond Cc8 and 2C)
    w1t = np.zeros((n, 3, two_c, cc8 + PASS + 64), np.float32)
    w1t[..., :cc] = ops["w1"].reshape(3, cc, n, two_c).transpose(2, 0, 3, 1)
    out = np.zeros((bsz, t, n * two_c), np.float32)
    for b in range(bsz):
        for _, _, u0 in wg_rows(t):
            u = u0 + np.arange(ROWS)
            for i in range(n):
                a = [bf16(act(ops, b, u, i, p, kh)) for p in range(npass)]
                for oc in range(-(-two_c // width)):
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
                    r = np.arange(OWN)
                    tt = u0 + 1 + r
                    okr, oko = tt < t, o < two_c
                    col = i * two_c + o[oko]
                    s = ((ops["b1"][col][None] + p_acc[r][:, :width][:, oko])
                         + p_acc[r + 1][:, width:2 * width][:, oko]) \
                        + p_acc[r + 2][:, 2 * width:][:, oko]
                    out[b, tt[okr][:, None], col[None]] = bf16(s[okr])
    return out


def w1_plan(bsz, t, n, npass, two_c):
    """k2b_w1_kernel's work (make_plan): units of 62 rows of g, chunked so
    that (block, pass, 64 columns of g) tiles x chunks make one wave of SMS
    CTAs: (units a batch row, units, units a chunk, chunks)."""
    nsub = -(-t // OWN)
    units = bsz * nsub
    tiles = n * npass * -(-two_c // 64)
    chunk = -(-units // min(max(1, SMS // tiles), units))
    return nsub, units, chunk, -(-units // chunk)


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


def k2_emulated(ops, g):
    """K2-bf16's arithmetic as its kernels take it (the data kernel's CTAs,
    k2b_w1_kernel's units and chunks, k2b_xdh_kernel's parts, the ordered
    reductions): the gradients' dict, f32 values of bf16."""
    bsz, t, e = ops["exc"].shape
    cc = ops["w1"].shape[1]
    n = ops["w0"].shape[2] // cc
    two_c = ops["w1"].shape[2] // n
    npass, kh = geo(e, cc)
    nec = -(-e // 8)
    n0 = n * cc
    dh_s = np.zeros((bsz, t, n0), np.float32)
    dexc = np.zeros((bsz, t, e), np.float32)
    for b in range(bsz):
        for tile, w, u0 in wg_rows(t):
            u = u0 + np.arange(ROWS)
            valid = (u >= 0) & (u < t)
            own = (np.arange(ROWS) >= 1) & (np.arange(ROWS) <= OWN) & (u < t)
            acc = None
            for i in range(n):
                for p in range(npass):
                    c = p * PASS + np.arange(PASS)
                    a = bf16(act(ops, b, u, i, p, kh))
                    # da: tap j, chunks of 64 columns of g, slices of 16
                    da = np.zeros((ROWS, PASS), np.float32)
                    for j in range(3):
                        r = u + 1 - j
                        ok = (r >= 0) & (r < t)
                        gj = np.zeros((ROWS, -(-two_c // 16) * 16), np.float32)
                        gj[ok, :two_c] = g[b, r[ok], i * two_c:(i + 1) * two_c]
                        wj = np.zeros((gj.shape[1], PASS), np.float32)
                        okc = c < cc
                        wj[:two_c, okc] = ops["w1"][j, c[okc], i * two_c:(i + 1) * two_c].T
                        da = slices16(gj, wj, da)
                    neg = np.signbit(a)
                    dh = np.where(valid[:, None], bf16(np.where(neg, SLOPE * da, da)), 0)
                    okc = c < cc
                    rows, cols = u[own], i * cc + c[okc]
                    dh_s[b, rows[:, None], cols[None]] = dh[own][:, okc]
                    # dexc: E in chunks of 8, dh rows r + 2 - j, K = 144
                    dh144 = np.concatenate([dh, np.zeros((ROWS, 8), np.float32)], 1)
                    w0x = np.zeros((3, 144, nec * 8), np.float32)
                    w0x[:, :PASS][:, okc, :e] = ops["w0"][:, :, cols].transpose(0, 2, 1)
                    dx = np.zeros((OWN, nec * 8), np.float32)
                    for ec in range(nec):
                        part = np.zeros((OWN, 8), np.float32)
                        for j in range(3):
                            part = slices16(dh144[2 - j:2 - j + OWN],
                                            w0x[j][:, ec * 8:(ec + 1) * 8], part)
                        dx[:, ec * 8:(ec + 1) * 8] = part
                    acc = dx if acc is None else acc + dx
            tt = u0 + 1 + np.arange(OWN)
            ok = tt < t
            dexc[b, tt[ok]] = bf16(acc[ok][:, :e])
    # dW1 and db1 (k2b_w1_kernel): a unit is 62 rows t0 + r of g (zero
    # outside [0, T), then two zero rows); a is recomputed for the rows
    # t0 - 1 + q, q < 64 (then 8 zero rows), tap j's B is a from row j; each
    # chunk of units sums in f32, slice by slice, unit by unit
    nsub, units, chunk, s1 = w1_plan(bsz, t, n, npass, two_c)
    pw1 = np.zeros((s1, 3, cc, n * two_c), np.float32)
    pb1 = np.zeros((s1, n * two_c), np.float32)
    for s in range(s1):
        acc, accb = {}, {}
        for k in range(s * chunk, min(units, (s + 1) * chunk)):
            b, t0 = k // nsub, (k % nsub) * OWN
            u = t0 - 1 + np.arange(ROWS)
            r = t0 + np.arange(ROWS)
            okr = (np.arange(ROWS) < OWN) & (r < t)
            for i in range(n):
                gt = np.zeros((ROWS, two_c), np.float32)
                gt[okr] = g[b, r[okr], i * two_c:(i + 1) * two_c]
                accb[i] = slices16(gt.T, np.ones((ROWS, 1), np.float32), accb.get(i))
                for p in range(npass):
                    a = np.zeros((ROWS + 8, PASS), np.float32)
                    a[:ROWS] = bf16(act(ops, b, u, i, p, kh))
                    for j in range(3):
                        acc[i, p, j] = slices16(gt.T, a[j:j + ROWS], acc.get((i, p, j)))
        for (i, p, j), v in acc.items():
            c = p * PASS + np.arange(PASS)
            pw1[s, j, c[c < cc], i * two_c:(i + 1) * two_c] = v[:, c < cc].T
        for i, v in accb.items():
            pb1[s, i * two_c:(i + 1) * two_c] = v[:, 0]
    # dW0, dhbias and the edges (k2b_xdh_kernel): X^T dh over the rows of
    # each part of each batch row, 64 rows a step, X zero past the part
    kx = 3 * e + 3
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k1_bf16_tiles_emulated(case):
    _, b, t, e, n, cc, two_c, concat = case
    ops = chain_ops(b, t, e, n, cc, two_c, seed=cc + two_c + e, concat=concat)
    want = cond_chain.cond_chain_plain(**torch_ops(ops))
    assert_ulp(k1_emulated(ops), want, "out")


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
    """k2b_w1_kernel's chunks on a card of 2 SMs: several units of 62 rows
    a chunk (at 132 SMs the file's small cases take one unit a chunk), a
    chunk ending inside a batch row and one crossing into the next; the
    per-chunk partials summed in order."""
    monkeypatch.setattr(sys.modules[__name__], "SMS", 2)
    _, b, t, e, n, cc, two_c, _ = CASES[0]
    assert w1_plan(3, 200, n, 1, two_c) == (4, 12, 12, 1)
    assert w1_plan(3, 200, 1, 1, two_c) == (4, 12, 6, 2)
    ops = chain_ops(3, 200, e, 1, cc, two_c, seed=11)
    g = bf16(np.random.default_rng(12).standard_normal((3, 200, two_c)).astype(np.float32))
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
