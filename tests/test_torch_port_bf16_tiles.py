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
- K2: g's tap windows read rows t0 + 62 w - j, zero outside [0, T) (the TMA
  copy's zero fill); da in h's accumulator layout; the slope from the sign
  of bf16(lrelu(h)) (with lrelu(-0) = +0, the sign of h); dexc summed over
  the blocks and passes in f32 and rounded once; dhbias in row groups of 7,
  per half tile; db1 in chunks of rows.

Operands are dyadic where a slope must agree (cond_0's sums exact in any
order), as on the card. Numpy only, no JAX compile.
"""

import shutil

import numpy as np
import pytest
import torch

from td_vc_gan_tpu_torch.ops.cuda import cond_chain

BF = torch.bfloat16
ULP_SHARE = 1e-2        # elements allowed beyond one bf16 ulp of the plain value
MAX_REL = 2.0 ** -7     # max|d| of max|plain|
TILE, OWN, ROWS, PASS = 124, 62, 64, 136
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


def k2_emulated(ops, g):
    """K2-bf16's arithmetic (the data kernel as its CTAs take it; the
    weight grads as f32 sums of the scratch): the gradients' dict, f32
    values of bf16."""
    bsz, t, e = ops["exc"].shape
    cc = ops["w1"].shape[1]
    n = ops["w0"].shape[2] // cc
    two_c = ops["w1"].shape[2] // n
    npass, kh = geo(e, cc)
    nec = -(-e // 8)
    ntiles = -(-t // TILE)
    n0 = n * cc
    a_s = np.zeros((bsz, t, n0), np.float32)
    dh_s = np.zeros((bsz, t, n0), np.float32)
    phb = np.zeros((bsz, 2 * ntiles, n0), np.float32)
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
                    a_s[b, rows[:, None], cols[None]] = a[own][:, okc]
                    dh_s[b, rows[:, None], cols[None]] = dh[own][:, okc]
                    # dhbias: row groups of 7, then the groups in order
                    part = np.zeros((7, PASS), np.float32)
                    for rg in range(7):
                        for q in range(1 + rg, OWN + 1, 7):
                            if u0 + q < t:
                                part[rg] = part[rg] + dh[q]
                    tot = part[0]
                    for rg in range(1, 7):
                        tot = tot + part[rg]
                    phb[b, 2 * tile + w, cols] = tot[okc]
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
    hb = ops["hbias"]
    if hb.ndim == 2:
        dhbias = np.zeros((bsz, n0), np.float32)
        for b in range(bsz):
            for s in range(2 * ntiles):
                dhbias[b] = dhbias[b] + phb[b, s]
    else:
        dhbias = np.zeros(n0, np.float32)
        for s in phb.reshape(-1, n0):
            dhbias = dhbias + s
    # db1: g's rows (B*T of them) in chunks of ceil(B*T / 264), then the chunks
    g2 = g.reshape(-1, n * two_c)
    rows = -(-g2.shape[0] // 264)
    db1 = np.zeros(n * two_c, np.float32)
    for s in range(0, g2.shape[0], rows):
        db1 = db1 + np.sum(g2[s:s + rows], 0, dtype=np.float32)
    # the weight grads from the scratch, summed in f32
    pad = lambda x: np.pad(x, ((0, 0), (1, 1), (0, 0)))  # noqa: E731
    ap, xp = pad(a_s), pad(ops["exc"])
    gb = g.reshape(bsz, t, n, two_c)
    dw1 = np.stack([np.einsum("btnc,btno->cno", ap[:, j:j + t].reshape(bsz, t, n, cc), gb)
                    .reshape(cc, n * two_c) for j in range(3)])
    dw0 = np.stack([np.einsum("bte,btk->ek", xp[:, j:j + t], dh_s) for j in range(3)])
    out = dict(exc=dexc, w0=bf16(dw0), hbias=bf16(dhbias), w1=bf16(dw1), b1=bf16(db1))
    if "edge0" in ops:
        out.update(edge0=-dh_s[:, 0], edge_t=-dh_s[:, t - 1])
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
    cond_chain_bf16.cuh): editing it rebuilds both and neither f32 library."""
    for src in (*cond_chain.SOURCES, *cond_chain.BF16_SOURCES,
                *cond_chain.SOURCES[0].parent.glob("*.cuh")):
        shutil.copy(src, tmp_path / src.name)
    bf = [tmp_path / s.name for s in cond_chain.BF16_SOURCES]
    f32 = [tmp_path / s.name for s in cond_chain.SOURCES]
    for src in bf:
        assert "hopper_bf16.cuh" in {p.name for p in cond_chain._sources_of(src)}
    for src in f32:
        assert "hopper_bf16.cuh" not in {p.name for p in cond_chain._sources_of(src)}
    before = [cond_chain._lib_path(x) for x in (*bf, *f32)]
    header = tmp_path / "hopper_bf16.cuh"
    header.write_text(header.read_text() + "\n")
    after = [cond_chain._lib_path(x) for x in (*bf, *f32)]
    assert after[0] != before[0] and after[1] != before[1] and after[2:] == before[2:]
