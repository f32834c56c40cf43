"""Minimal dependency-free JPEG (JFIF) decoder (copy of
rodent_tpu/io/jpg.py).

Plays the role of the reference's libjpeg wrapper
(src/driver/image.cpp:131-195, rodent_load_jpg) for `map_*` material
textures. Clean-room implementation of ITU-T T.81 Huffman DCT:

- baseline sequential (SOF0/SOF1): 8-bit samples, restart intervals,
  4:4:4 / 4:2:2 / 4:2:0 chroma subsampling;
- progressive (SOF2): spectral selection + successive approximation
  (DC first/refine, AC first/refine with EOB runs), interleaved DC and
  single-component scans, restart intervals — libjpeg decodes these
  (image.cpp uses the full jpeg_read_* API), so we must too.

Arithmetic-coded and hierarchical JPEGs are rejected with a clear error.

Entropy decoding is serial Python (texture loads are host-side, offline);
dequantization, IDCT (separable DCT-III matrix form) and color conversion
are vectorized numpy over all blocks.
"""
from __future__ import annotations

import struct

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# IDCT basis: A[u, x] = c(u)/2 * cos((2x+1) u pi / 16); block = A.T S A
_A = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * 0.5
                * np.cos((2 * x + 1) * u * np.pi / 16.0)
                for x in range(8)] for u in range(8)], np.float64)


class _Huff:
    """Canonical Huffman table: (length, code) -> symbol."""

    def __init__(self, counts, symbols):
        self.lut = {}
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(counts[ln - 1]):
                self.lut[(ln, code)] = symbols[k]
                code += 1
                k += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over byte-unstuffed entropy data."""

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def bit(self):
        if self.nbits == 0:
            if self.pos >= len(self.data):
                return 0  # pad past the end (T.81 F.2.2.5 fill bits)
            self.acc = self.data[self.pos]
            self.pos += 1
            self.nbits = 8
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def decode(self, table):
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | self.bit()
            sym = table.lut.get((ln, code))
            if sym is not None:
                return sym
        raise ValueError("invalid JPEG: bad Huffman code")


def _extend(v, s):
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _entropy_segments(data, pos):
    """Collects one scan's entropy-coded data starting at `pos`:
    byte-unstuffs FF00, splits at restart markers (RST0-7), stops at any
    other marker. Returns (list of segments, position of the next
    marker's 0xFF byte)."""
    segs = []
    cur = bytearray()
    i = pos
    n = len(data)
    while i < n:
        b = data[i]
        if b == 0xFF:
            nxt = data[i + 1] if i + 1 < n else 0xD9
            if nxt == 0x00:
                cur.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:  # restart marker
                segs.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
            break
        cur.append(b)
        i += 1
    segs.append(bytes(cur))
    return segs, i


def read_jpg(path):
    """Decodes a baseline or progressive JPEG into a (H, W, 3) uint8 RGB
    array (grayscale broadcast to RGB, matching texture.image_from_u8's
    contract)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}
    huff_dc, huff_ac = {}, {}
    frame = None
    dri = 0
    eobrun = [0]  # EOB run carries across blocks within an AC scan
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        pos += seglen
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                i += 1
                if pq:
                    vals = np.frombuffer(seg[i:i + 128], ">u2").astype(
                        np.int32)
                    i += 128
                else:
                    vals = np.frombuffer(seg[i:i + 64], np.uint8).astype(
                        np.int32)
                    i += 64
                qt[tq] = vals
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 prog
            _prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            frame = {"h": h, "w": w, "comps": comps,
                     "progressive": marker == 0xC2}
            _alloc_coefs(frame)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError("only baseline/progressive Huffman JPEG is "
                             f"supported (SOF marker 0x{marker:02x})")
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                nsym = sum(counts)
                syms = list(seg[i + 17:i + 17 + nsym])
                (huff_ac if tc else huff_dc)[th] = _Huff(counts, syms)
                i += 17 + nsym
        elif marker == 0xDD:  # DRI
            (dri,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("invalid JPEG: SOS before SOF")
            nc = seg[0]
            scan = []
            for c in range(nc):
                cs, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                scan.append({"cs": cs, "td": tt >> 4, "ta": tt & 15})
            ss, se, a = seg[1 + 2 * nc:4 + 2 * nc]
            ah, al = a >> 4, a & 15
            if not frame["progressive"]:
                ss, se, ah, al = 0, 63, 0, 0
            pos = _decode_scan(data, pos, frame, scan, huff_dc, huff_ac,
                               dri, ss, se, ah, al, eobrun)
    if frame is None:
        raise ValueError("invalid JPEG: no frame found")
    return _reconstruct(frame, qt)


def _alloc_coefs(frame):
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    frame["hmax"], frame["vmax"] = hmax, vmax
    frame["mcux"] = -(-frame["w"] // (8 * hmax))
    frame["mcuy"] = -(-frame["h"] // (8 * vmax))
    for c in comps:
        c["bw"] = frame["mcux"] * c["h"]   # padded blocks per row
        c["bh"] = frame["mcuy"] * c["v"]
        # the component's own (unpadded) block grid, for
        # non-interleaved scans (T.81 A.2.2)
        c["cbw"] = -(-(-(-frame["w"] * c["h"] // hmax)) // 8)
        c["cbh"] = -(-(-(-frame["h"] * c["v"] // vmax)) // 8)
        c["coef"] = np.zeros((c["bh"] * c["bw"], 64), np.int64)


def _decode_scan(data, pos, frame, scan, huff_dc, huff_ac, dri,
                 ss, se, ah, al, eobrun):
    """Decodes one entropy-coded scan into the frame's coefficient
    arrays; returns the stream position after the scan. Handles
    interleaved (multi-component) and single-component scans, spectral
    band [ss, se], successive approximation (ah=0 first pass, ah>0
    refinement), EOB runs, and restart intervals."""
    comps = frame["comps"]
    by_id = {c["id"]: c for c in comps}
    sc = [dict(s, c=by_id[s["cs"]]) for s in scan]
    segs, endpos = _entropy_segments(data, pos)
    eobrun[0] = 0

    interleaved = len(sc) > 1
    if interleaved:
        nunits = frame["mcux"] * frame["mcuy"]
    else:
        c = sc[0]["c"]
        nunits = c["cbw"] * c["cbh"]

    seg_i = 0
    rd = _BitReader(segs[0])
    pred = {s["cs"]: 0 for s in sc}
    for unit in range(nunits):
        if dri and unit and unit % dri == 0 and seg_i + 1 < len(segs):
            seg_i += 1
            rd = _BitReader(segs[seg_i])
            pred = {s["cs"]: 0 for s in sc}
            eobrun[0] = 0
        if interleaved:
            my, mx = divmod(unit, frame["mcux"])
            for s in sc:
                c = s["c"]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        blk = c["coef"][(my * c["v"] + by) * c["bw"]
                                        + (mx * c["h"] + bx)]
                        _decode_block(rd, blk, s, huff_dc, huff_ac,
                                      pred, ss, se, ah, al, eobrun)
        else:
            s = sc[0]
            c = s["c"]
            by, bx = divmod(unit, c["cbw"])
            blk = c["coef"][by * c["bw"] + bx]
            _decode_block(rd, blk, s, huff_dc, huff_ac, pred,
                          ss, se, ah, al, eobrun)
    return endpos


def _decode_block(rd, blk, s, huff_dc, huff_ac, pred, ss, se, ah, al,
                  eobrun):
    """One 8x8 block's contribution for the scan's band [ss, se] at
    approximation bit al (blk is zigzag-ordered). T.81 F.2.2 (baseline),
    G.2 (progressive)."""
    if ss == 0:
        if ah == 0:  # DC first pass (baseline: al = 0)
            t = rd.decode(huff_dc[s["td"]])
            diff = _extend(rd.bits(t), t) if t else 0
            pred[s["cs"]] += diff
            blk[0] = pred[s["cs"]] << al
        else:        # DC refinement: one bit, OR into bit al
            if rd.bit():
                blk[0] |= 1 << al
        if se == 0:
            return
        k0 = 1
    else:
        k0 = ss

    ac_t = huff_ac[s["ta"]]
    if ah == 0:
        # AC first pass (covers baseline, where eobrun degenerates to
        # the plain EOB: r == 0 -> eobrun = 0)
        if eobrun[0] > 0:
            eobrun[0] -= 1
            return
        k = k0
        while k <= se:
            rs = rd.decode(ac_t)
            r, size = rs >> 4, rs & 15
            if size == 0:
                if r == 15:
                    k += 16  # ZRL
                    continue
                eobrun[0] = (1 << r) - 1
                if r:
                    eobrun[0] += rd.bits(r)
                break  # EOB(n)
            k += r
            if k > se:
                raise ValueError("invalid JPEG: AC overflow")
            blk[k] = _extend(rd.bits(size), size) << al
            k += 1
    else:
        # AC refinement (T.81 G.1.2.3 / libjpeg decode_mcu_AC_refine):
        # correction bits for already-nonzero coefficients, newly
        # significant coefficients appear with magnitude 1 << al
        p1 = 1 << al
        m1 = -1 << al

        def refine(k):
            if rd.bit() and not (blk[k] & p1):
                blk[k] += p1 if blk[k] >= 0 else m1

        k = k0
        if eobrun[0] == 0:
            while k <= se:
                rs = rd.decode(ac_t)
                r, size = rs >> 4, rs & 15
                val = 0
                if size == 0:
                    if r < 15:
                        eobrun[0] = (1 << r) - 1
                        if r:
                            eobrun[0] += rd.bits(r)
                        r = 64  # refine the rest of the band, then stop
                else:
                    # size is always 1 in a refinement scan
                    val = p1 if rd.bit() else m1
                while k <= se:
                    if blk[k] != 0:
                        refine(k)
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if k <= se:
                    if val:
                        blk[k] = val
                    k += 1
        else:
            eobrun[0] -= 1
            while k <= se:
                if blk[k] != 0:
                    refine(k)
                k += 1


def _reconstruct(frame, qt):
    """Dequantize + dezigzag + IDCT + upsample + color-convert,
    vectorized over all blocks."""
    comps = frame["comps"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    planes = []
    for c in comps:
        deq = c["coef"] * qt[c["tq"]][None, :]
        blocks = np.zeros((len(deq), 64), np.float64)
        blocks[:, _ZIGZAG] = deq
        blocks = blocks.reshape(-1, 8, 8)
        pix = np.einsum("ux,nuv,vy->nxy", _A, blocks, _A) + 128.0
        plane = pix.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        # upsample to full resolution
        plane = np.repeat(np.repeat(plane, vmax // c["v"], axis=0),
                          hmax // c["h"], axis=1)
        planes.append(plane[:frame["h"], :frame["w"]])

    if len(planes) == 1:
        y = np.clip(planes[0], 0, 255).astype(np.uint8)
        return np.stack([y, y, y], axis=-1)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1).round(), 0,
                   255).astype(np.uint8)
