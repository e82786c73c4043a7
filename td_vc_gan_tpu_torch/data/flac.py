"""First-party FLAC codec (decode: full subset; encode: test-grade).

The port's own copy of ``td_vc_gan_tpu/data/flac.py``, unchanged in
behaviour: the card's machine has no soundfile, so FLAC is decoded here.

The reference reads .flac via soundfile/libsndfile (data/dataset.py:106-108);
this image has neither, so hermetic FLAC support is implemented here from the
container spec: STREAMINFO parse, frame sync, UTF-8 frame numbers,
constant/verbatim/fixed/LPC subframes, rice/rice2 residual partitions,
wasted bits, and all four stereo decorrelation modes. CRCs are not verified
(decode-for-training tolerance, like the reference's exception-tolerant
loader).

Performance note: this is the *compatibility* path (numpy bit reader,
sequential rice loop — roughly realtime on one core). Training-scale corpora
should be converted to wav once (the JAX package's cli/preprocess_dataset.py); read_audio
prefers soundfile when installed and only then falls back here.

The encoder exists to round-trip-test the decoder hermetically (no flac
binary in the image): it writes constant, verbatim, and fixed-order-2
rice-coded subframes — enough to exercise every decoder branch except LPC,
which is covered by a hand-built bitstream in the tests.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_SAMPLE_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_SR_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
             7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}


class _Bits:
    """MSB-first bit reader over the whole byte buffer (numpy-backed)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.ones = np.flatnonzero(self.bits)  # for O(log n) unary scans
        self.pos = 0
        self._pow = (1 << np.arange(63, -1, -1, dtype=np.uint64)).astype(np.uint64)

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        sl = self.bits[self.pos:self.pos + n]
        if sl.size < n:
            raise EOFError("flac: bitstream truncated")
        self.pos += n
        return int(np.dot(sl.astype(np.uint64), self._pow[-n:]))

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def unary(self) -> int:
        i = np.searchsorted(self.ones, self.pos)
        if i >= self.ones.size:
            raise EOFError("flac: bitstream truncated in unary code")
        q = int(self.ones[i]) - self.pos
        self.pos = int(self.ones[i]) + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def utf8_number(self) -> int:
        """Frame/sample number: UTF-8-style coding up to 7 bytes."""
        b0 = self.u(8)
        if b0 < 0x80:
            return b0
        n = 0
        while (b0 << n) & 0x80:
            n += 1
        val = b0 & (0x7F >> n)
        for _ in range(n - 1):
            val = (val << 6) | (self.u(8) & 0x3F)
        return val


def _decode_residual(br: _Bits, blocksize: int, order: int) -> np.ndarray:
    method = br.u(2)
    if method > 1:
        raise ValueError(f"flac: reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.u(4)
    nparts = 1 << part_order
    if blocksize % nparts:
        raise ValueError("flac: partition count does not divide blocksize")
    out = np.empty(blocksize - order, dtype=np.int64)
    idx = 0
    for p in range(nparts):
        n = blocksize // nparts - (order if p == 0 else 0)
        param = br.u(plen)
        if param == escape:
            bits = br.u(5)
            for i in range(n):
                out[idx + i] = br.s(bits) if bits else 0
        else:
            for i in range(n):
                q = br.unary()
                r = br.u(param) if param else 0
                z = (q << param) | r
                out[idx + i] = (z >> 1) ^ -(z & 1)  # zigzag
        idx += n
    return out


def _decode_subframe(br: _Bits, blocksize: int, bps: int) -> np.ndarray:
    if br.u(1):
        raise ValueError("flac: subframe pad bit set")
    stype = br.u(6)
    wasted = 0
    if br.u(1):
        wasted = br.unary() + 1
        bps -= wasted
    if stype == 0:  # constant
        out = np.full(blocksize, br.s(bps), dtype=np.int64)
    elif stype == 1:  # verbatim
        out = np.array([br.s(bps) for _ in range(blocksize)], dtype=np.int64)
    elif 8 <= stype <= 12:  # fixed, order = stype & 7
        order = stype & 7
        warm = [br.s(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * out[i - 1 - j]
            out[i] = acc
    elif stype >= 32:  # LPC, order = (stype & 31) + 1
        order = (stype & 31) + 1
        warm = [br.s(bps) for _ in range(order)]
        precision = br.u(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid lpc precision escape")
        shift = br.s(5)
        coefs = [br.s(precision) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warm
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * out[i - 1 - j]
            out[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float64 signal in [-1,1] (mono) or
    (frames, channels), sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream")
    pos = 4
    sr = bits_per_sample = nch = total = None
    while True:
        hdr = data[pos:pos + 4]
        last, btype = hdr[0] >> 7, hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:  # STREAMINFO
            raw = int.from_bytes(body[10:18], "big")
            sr = raw >> 44
            nch = ((raw >> 41) & 0x7) + 1
            bits_per_sample = ((raw >> 36) & 0x1F) + 1
            total = raw & ((1 << 36) - 1)
        pos += 4 + size
        if last:
            break
    if sr is None:
        raise ValueError(f"{path}: missing STREAMINFO")

    br = _Bits(data[pos:])
    chans: list[list[np.ndarray]] = [[] for _ in range(nch)]
    got = 0
    while (total == 0 or got < total) and br.pos + 32 <= br.bits.size:
        sync = br.u(14)
        if sync != 0x3FFE:
            raise ValueError(f"flac: lost frame sync (0x{sync:x})")
        br.u(1)  # reserved
        br.u(1)  # blocking strategy
        bs_code = br.u(4)
        sr_code = br.u(4)
        ch_assign = br.u(4)
        ss_code = br.u(3)
        br.u(1)  # reserved
        br.utf8_number()
        if bs_code == 6:
            blocksize = br.u(8) + 1
        elif bs_code == 7:
            blocksize = br.u(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.u(8)
        elif sr_code in (13, 14):
            br.u(16)
        bps = _SAMPLE_SIZE_TABLE.get(ss_code, bits_per_sample)
        br.u(8)  # header CRC-8 (not verified)

        if ch_assign < 8:
            if ch_assign + 1 != nch:
                raise ValueError("flac: channel count mismatch")
            subs = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
        else:
            # stereo decorrelation: the side channel carries one extra bit
            extra = [0, 1] if ch_assign in (8, 10) else [1, 0]
            a = _decode_subframe(br, blocksize, bps + extra[0])
            b = _decode_subframe(br, blocksize, bps + extra[1])
            if ch_assign == 8:  # left/side
                subs = [a, a - b]
            elif ch_assign == 9:  # right/side
                subs = [b + a, b]
            else:  # mid/side
                mid, side = a, b
                mid2 = (mid << 1) | (side & 1)
                subs = [(mid2 + side) >> 1, (mid2 - side) >> 1]
        br.align()
        br.u(16)  # frame CRC-16 (not verified)
        for c in range(nch):
            chans[c].append(subs[c])
        got += blocksize

    sig = np.stack([np.concatenate(c) for c in chans], axis=-1).astype(np.float64)
    if total:
        sig = sig[:total]
    sig /= float(1 << (bits_per_sample - 1))
    if nch == 1:
        sig = sig[:, 0]
    return sig, sr


# ---------------------------------------------------------------------------
# Test-grade encoder
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def w(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nacc += 1
            if self.nacc == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.nacc = 0

    def ws(self, value: int, n: int) -> None:
        self.w(value & ((1 << n) - 1), n)

    def align(self) -> None:
        while self.nacc:
            self.w(0, 1)


def _encode_rice(bw: _BitWriter, res: np.ndarray, param: int) -> None:
    for v in res:
        z = (int(v) << 1) ^ (int(v) >> 63)  # zigzag (arithmetic shift)
        q, r = z >> param, z & ((1 << param) - 1)
        bw.w(0, q)
        bw.w(1, 1)
        if param:
            bw.w(r, param)


def write_flac(path: str | Path, signal: np.ndarray, sr: int,
               blocksize: int = 4096) -> None:
    """Encode a mono/stereo int16-range float signal as FLAC.

    Per-block subframe choice: constant when flat, else fixed order 2 with a
    single rice partition, else (tiny blocks) verbatim — the decoder-test
    round-trip exercises those three paths plus the container framing.
    """
    sig = np.asarray(signal)
    if sig.ndim == 1:
        sig = sig[:, None]
    pcm = np.clip(np.round(sig * 32767.0), -32768, 32767).astype(np.int64)
    n, nch = pcm.shape
    bps = 16

    bw = _BitWriter()
    bw.out += b"fLaC"
    # STREAMINFO, last-metadata-block flag set
    bw.w(1, 1)
    bw.w(0, 7)
    bw.w(34, 24)
    bw.w(blocksize, 16)
    bw.w(blocksize, 16)
    bw.w(0, 24)
    bw.w(0, 24)
    bw.w(sr, 20)
    bw.w(nch - 1, 3)
    bw.w(bps - 1, 5)
    bw.w(n, 36)
    for _ in range(16):
        bw.w(0, 8)  # md5 unset

    for fi, start in enumerate(range(0, n, blocksize)):
        blk = pcm[start:start + blocksize]
        bs = blk.shape[0]
        bw.w(0x3FFE, 14)
        bw.w(0, 1)
        bw.w(0, 1)  # fixed blocksize strategy
        bw.w(7, 4)  # blocksize: 16 bit at end of header
        bw.w(13, 4)  # sample rate: 16 bit Hz at end of header
        bw.w(nch - 1, 4)  # independent channels
        bw.w(4, 3)  # 16-bit samples
        bw.w(0, 1)
        assert fi < 0x80, "test encoder: frame number must fit 1 utf8 byte"
        bw.w(fi, 8)
        bw.w(bs - 1, 16)
        bw.w(sr, 16)
        bw.w(0, 8)  # CRC-8 unverified by our decoder

        for c in range(nch):
            x = blk[:, c]
            bw.w(0, 1)
            if np.all(x == x[0]):
                bw.w(0, 6)  # constant
                bw.w(0, 1)  # no wasted bits
                bw.ws(int(x[0]), bps)
            elif bs > 2:
                order = 2
                bw.w(8 | order, 6)  # fixed order 2
                bw.w(0, 1)
                bw.ws(int(x[0]), bps)
                bw.ws(int(x[1]), bps)
                res = x[2:] - 2 * x[1:-1] + x[:-2]
                mean = max(float(np.mean(np.abs(res))), 1.0)
                param = min(14, max(0, int(np.ceil(np.log2(mean + 1))) + 1))
                bw.w(0, 2)  # rice method
                bw.w(0, 4)  # partition order 0
                bw.w(param, 4)
                _encode_rice(bw, res, param)
            else:
                bw.w(1, 6)  # verbatim
                bw.w(0, 1)
                for v in x:
                    bw.ws(int(v), bps)
        bw.align()
        bw.w(0, 16)  # CRC-16 unverified by our decoder
    bw.align()
    Path(path).write_bytes(bytes(bw.out))
