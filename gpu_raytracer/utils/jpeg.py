"""Minimal JPEG decoder, baseline + progressive (pure NumPy + stdlib).

The reference ingests JPEG textures through the Rust `image` crate
(src/gltf_loader.rs:128-184); this environment has no image
codecs (zero egress, no Pillow), so real Sponza-class glTF assets — whose
textures overwhelmingly ship as baseline JPEG — need a from-scratch decoder.

Scope: baseline sequential DCT (SOF0; SOF1 accepted) AND progressive DCT
(SOF2: spectral selection + successive approximation, DC/AC first and
refinement scans, EOB runs — ITU T.81 §G), 8-bit precision, grayscale or
YCbCr with 4:4:4 / 4:2:2 / 4:2:0 / 4:1:1 sampling, restart markers, byte
stuffing. Arithmetic coding and 12-bit are rejected with a clear error.
Huffman + run-length decoding is a Python loop filling one
[blocks_y, blocks_x, 64] coefficient grid per component (progressive scans
refine the same grid in place); dequantisation, zig-zag, IDCT (one einsum
over all blocks) and YCbCr→RGB are vectorised — a 1024² texture decodes in
a few seconds, which is load-time cost only (textures then live in the
device atlas).
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["decode_jpeg", "JpegError"]


class JpegError(ValueError):
    pass


# zig-zag index: position in the 8x8 block for coefficient k of the scan
_ZIGZAG = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int32)

# 8-point DCT-III basis (IDCT): x = C^T @ X @ C with orthonormal scaling
_k = np.arange(8)
_C = np.cos((2 * _k[None, :] + 1) * _k[:, None] * np.pi / 16) * \
    np.where(_k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))


class _HuffTable:
    """Canonical Huffman table with a 16-bit peek LUT for O(1) decode."""

    def __init__(self, counts: np.ndarray, symbols: bytes):
        self.counts = np.asarray(counts, np.uint8)   # raw DHT payload (for
        self.symbols = bytes(symbols)                # the native decoder)
        lut_sym = np.zeros(1 << 16, np.uint8)
        lut_len = np.zeros(1 << 16, np.uint8)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(int(counts[length - 1])):
                sym = symbols[k]
                k += 1
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                if hi > (1 << 16):
                    # overfull canonical code space: a corrupt DHT. numpy
                    # slicing would clamp silently and decode garbage; the
                    # native decoder rejects the same table (rc -1), so
                    # fail identically here.
                    raise JpegError("overfull Huffman table (corrupt DHT)")
                lut_sym[lo:hi] = sym
                lut_len[lo:hi] = length
                code += 1
            code <<= 1
        self.lut_sym = lut_sym
        self.lut_len = lut_len


class _BitReader:
    """MSB-first bit reader over entropy-coded bytes (stuffing pre-stripped)."""

    def __init__(self, buf: np.ndarray):
        self.buf = buf          # uint8 array
        self.pos = 0            # byte position
        self.acc = 0            # bit accumulator (int)
        self.nbits = 0

    def _fill(self, need: int) -> None:
        while self.nbits < need:
            b = int(self.buf[self.pos]) if self.pos < len(self.buf) else 0
            self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFFFF
            self.nbits += 8

    def peek16(self) -> int:
        self._fill(16)
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int) -> None:
        self.nbits -= n

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        return v


def _comp_blocks(size: int, samp: int, smax: int) -> int:
    """Blocks per non-interleaved scan line/column (T.81 A.2.2):
    ceil(ceil(size*samp/smax) / 8)."""
    comp = -(-size * samp // smax)
    return -(-comp // 8)


def _extend(v: int, s: int) -> int:
    """JPEG signed-magnitude extension (ITU T.81 F.2.2.1)."""
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _huff_decode(br: _BitReader, table: _HuffTable) -> int:
    p16 = br.peek16()
    ln = int(table.lut_len[p16])
    if ln == 0:
        raise JpegError("bad Huffman code")
    br.skip(ln)
    return int(table.lut_sym[p16])


def _extract_entropy(data: bytes, pos: int):
    """Entropy-coded bytes from `pos` to the next real marker: strips 0xFF00
    stuffing, drops RSTn markers but records the compacted byte offset just
    AFTER each (for byte-aligned restart resync). Returns
    (ent_bytes, rst_offsets, next_marker_pos)."""
    n = len(data)
    raw = np.frombuffer(data, np.uint8, n - pos, pos)
    ff = np.nonzero(raw[:-1] == 0xFF)[0]
    nxt = raw[ff + 1]
    end_candidates = ff[(nxt != 0x00) & ~((nxt >= 0xD0) & (nxt <= 0xD7))]
    end = int(end_candidates[0]) if end_candidates.size else len(raw)
    raw = raw[:end]
    drop = np.zeros(len(raw), bool)
    stuff = ff[(ff < end - 1) & (raw[np.minimum(ff + 1, end - 1)] == 0x00)]
    rst = ff[(ff < end - 1) & (raw[np.minimum(ff + 1, end - 1)] >= 0xD0)
             & (raw[np.minimum(ff + 1, end - 1)] <= 0xD7)]
    drop[stuff + 1] = True                               # the 0x00 after FF
    drop[rst] = True                                     # FF of RSTn
    drop[rst + 1] = True                                 # the RSTn byte
    keep = ~drop
    comp_idx = np.cumsum(keep) - 1
    ent = raw[keep]
    rst_after = rst + 2
    rst_list = [int(comp_idx[p]) if p < end else len(ent)
                for p in np.sort(rst_after).tolist()]
    return ent, rst_list, pos + end


def _block_first(br, row, dc, ac, pred, ss, se, al, state):
    """First-pass decode of one block's (ss..se) band at shift `al` —
    covers baseline (ss=0, se=63, al=0: T.81 §F.2.2) and progressive first
    scans (§G.1.2.1/G.1.2.2, incl. EOB runs). Returns the new DC pred."""
    if state["eobrun"] > 0:                  # inside an AC EOB run
        state["eobrun"] -= 1
        return pred
    k = ss
    if ss == 0:                              # DC (never EOB-run coded)
        s = _huff_decode(br, dc)
        diff = _extend(br.read(s), s) if s else 0
        pred += diff
        row[0] = pred << al
        k = 1
    while k <= se:
        rs = _huff_decode(br, ac)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r == 15:                      # ZRL: 16 zeros
                k += 16
                continue
            state["eobrun"] = (1 << r) - 1   # EOBn: this block + 2^r-1 more
            if r:
                state["eobrun"] += br.read(r)
            break
        k += r
        if k > 63:
            break                            # corrupt stream; tolerate
        row[k] = _extend(br.read(s), s) << al
        k += 1
    return pred


def _block_refine_ac(br, row, ac, ss, se, al, state):
    """AC successive-approximation refinement (T.81 §G.1.2.3, the
    decode_mcu_AC_refine logic): nonzero-history coefficients take one
    correction bit each; zero-history runs carry newly significant ±1<<al
    coefficients."""
    p1 = 1 << al
    m1 = -(1 << al)
    k = ss
    if state["eobrun"] == 0:
        while k <= se:
            rs = _huff_decode(br, ac)
            r, s = rs >> 4, rs & 15
            newval = 0
            if s == 0:
                if r < 15:                   # EOBn
                    state["eobrun"] = 1 << r
                    if r:
                        state["eobrun"] += br.read(r)
                    break
                # r == 15: ZRL — pass 16 zero-history coefficients
            else:                            # s == 1 per spec
                newval = p1 if br.read(1) else m1
            while k <= se:                   # advance, correcting nonzeros
                if row[k] != 0:
                    if br.read(1) and (int(row[k]) & p1) == 0:
                        row[k] += p1 if row[k] >= 0 else m1
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if newval and k <= se:
                row[k] = newval
            k += 1
    if state["eobrun"] > 0:                  # EOB run: corrections only
        while k <= se:
            if row[k] != 0:
                if br.read(1) and (int(row[k]) & p1) == 0:
                    row[k] += p1 if row[k] >= 0 else m1
            k += 1
        state["eobrun"] -= 1


# ---- native scan decoder (csrc/jpeg_scan.cpp): the serial entropy loop in
# C++, built at first use (utils/native.py); everything else stays
# vectorised Python.
_NATIVE = None
use_native = True     # tests flip this to force the Python loop


def _load_native():
    global _NATIVE
    if _NATIVE is None:
        import ctypes

        from .native import load

        lib = load("libjpeg_scan.so")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.jpeg_decode_scan.restype = ctypes.c_int
        lib.jpeg_decode_scan.argtypes = [
            u8p, ctypes.c_int64,                      # ent
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,  # rst offsets
            ctypes.c_int32,                           # restart_interval
            u8p, ctypes.c_int32,                      # tables, ncomp
            i32p, i32p,                               # comp_h, comp_v
            ctypes.c_int32, ctypes.c_int32,           # mcus_x, mcus_y
            ctypes.c_int32, ctypes.c_int32,           # bw, bh
            ctypes.c_int32, ctypes.c_int32,           # ss, se
            ctypes.c_int32, ctypes.c_int32,           # ah, al
            ctypes.POINTER(ctypes.c_void_p), i32p,    # coef ptrs, grid_w
        ]
        _NATIVE = lib
    return _NATIVE


def _decode_scan_native(sc, comp_state, frame_dims) -> bool:
    """Run one scan through csrc/libjpeg_scan.so. Returns False when
    `use_native` is off (the caller runs the Python loop);
    raises JpegError on a corrupt bitstream, like the Python path."""
    lib = _load_native() if use_native else None
    if lib is None:
        return False
    import ctypes

    W, H, hmax, vmax, mcus_x, mcus_y = frame_dims
    ncomp = len(sc["comps"])
    tables = np.zeros((ncomp, 2, 272), np.uint8)
    for c, (_cid, dc, ac) in enumerate(sc["comps"]):
        for j, t in enumerate((dc, ac)):
            if t is not None:
                tables[c, j, :16] = t.counts
                tables[c, j, 16:16 + len(t.symbols)] = np.frombuffer(
                    t.symbols, np.uint8)
    comp_h = np.asarray([comp_state[cid]["h"] for cid, _, _ in sc["comps"]],
                        np.int32)
    comp_v = np.asarray([comp_state[cid]["v"] for cid, _, _ in sc["comps"]],
                        np.int32)
    grids = [comp_state[cid]["coef"] for cid, _, _ in sc["comps"]]
    gw = np.asarray([g.shape[1] for g in grids], np.int32)
    ptrs = (ctypes.c_void_p * ncomp)(
        *[g.ctypes.data for g in grids])
    if ncomp == 1:
        ci = comp_state[sc["comps"][0][0]]
        bw = _comp_blocks(W, ci["h"], hmax)
        bh = _comp_blocks(H, ci["v"], vmax)
    else:
        bw = bh = 0
    ent = np.ascontiguousarray(sc["ent"])
    rst = np.ascontiguousarray(np.asarray(sc["rst"], np.int64))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.jpeg_decode_scan(
        ent.ctypes.data_as(u8p), ent.shape[0],
        rst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), rst.shape[0],
        sc["restart_interval"], tables.ctypes.data_as(u8p), ncomp,
        comp_h.ctypes.data_as(i32p), comp_v.ctypes.data_as(i32p),
        mcus_x, mcus_y, bw, bh, sc["ss"], sc["se"], sc["ah"], sc["al"],
        ptrs, gw.ctypes.data_as(i32p))
    if rc != 0:
        raise JpegError("bad Huffman code")
    return True


def _decode_scan(sc, comp_state, frame_dims) -> None:
    """Run one scan (baseline or progressive) over the component coefficient
    grids. Interleaved MCU order for multi-component scans, raster block
    order for single-component scans (T.81 §A.2.2/§A.2.3)."""
    W, H, hmax, vmax, mcus_x, mcus_y = frame_dims
    ss, se, ah, al = sc["ss"], sc["se"], sc["ah"], sc["al"]
    ri = sc["restart_interval"]
    rst_list = sc["rst"]
    br = _BitReader(sc["ent"])
    state = {"eobrun": 0}
    refine = ah != 0
    preds = {cid: 0 for cid, _, _ in sc["comps"]}

    def resync(j):
        br.acc = 0
        br.nbits = 0
        # exhausted restart list (truncated stream): seek to END so the
        # remaining blocks decode from zero bits — identical to the native
        # decoder (csrc/jpeg_scan.cpp resync)
        br.pos = rst_list[j] if j < len(rst_list) else len(br.buf)
        for c in preds:
            preds[c] = 0
        state["eobrun"] = 0

    if len(sc["comps"]) == 1:                # non-interleaved: one block/MCU
        cid, dc, ac = sc["comps"][0]
        ci = comp_state[cid]
        bw = _comp_blocks(W, ci["h"], hmax)
        bh = _comp_blocks(H, ci["v"], vmax)
        for u in range(bw * bh):
            if ri and u and u % ri == 0:
                resync(u // ri - 1)
            row = ci["coef"][u // bw, u % bw]
            if refine:
                if ss == 0:                  # DC refinement: one bit
                    if br.read(1):
                        row[0] |= 1 << al
                else:
                    _block_refine_ac(br, row, ac, ss, se, al, state)
            else:
                preds[cid] = _block_first(br, row, dc, ac, preds[cid],
                                          ss, se, al, state)
        return

    for mcu in range(mcus_x * mcus_y):       # interleaved (DC / baseline)
        if ri and mcu and mcu % ri == 0:
            resync(mcu // ri - 1)
        my, mx = divmod(mcu, mcus_x)
        for cid, dc, ac in sc["comps"]:
            ci = comp_state[cid]
            for v in range(ci["v"]):
                for h in range(ci["h"]):
                    row = ci["coef"][my * ci["v"] + v, mx * ci["h"] + h]
                    if refine:               # interleaved refine = DC only
                        if br.read(1):
                            row[0] |= 1 << al
                    else:
                        preds[cid] = _block_first(br, row, dc, ac,
                                                  preds[cid], ss, se, al,
                                                  state)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode baseline OR progressive JPEG bytes → [H,W,4] uint8 RGBA
    (alpha=255)."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG (missing SOI)")

    qt: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], _HuffTable] = {}
    restart_interval = 0
    frame = None          # (H, W, comps) where comps = [(cid, h, v, tq)]
    scans: list[dict] = []

    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:                               # fill byte (B.1.1.2)
            pos += 1
            continue
        if marker == 0xD9:                               # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        (seglen,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + seglen]
        if marker in (0xC0, 0xC1, 0xC2):                 # SOF0/1 + SOF2
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise JpegError(f"unsupported precision {prec}")
            if nc > 4:
                raise JpegError(f"unsupported component count {nc}")
            comps = []
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append((cid, hv >> 4, hv & 15, tq))
            frame = (H, W, comps)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
                        0xCE, 0xCF):
            raise JpegError(f"unsupported SOF marker 0xFF{marker:02X}")
        elif marker == 0xC4:                             # DHT
            p = 0
            while p < len(body):
                tc_th = body[p]
                counts = np.frombuffer(body, np.uint8, 16, p + 1)
                total = int(counts.sum())
                syms = body[p + 17:p + 17 + total]
                huff[(tc_th >> 4, tc_th & 15)] = _HuffTable(counts, syms)
                p += 17 + total
        elif marker == 0xDB:                             # DQT
            p = 0
            while p < len(body):
                pq_tq = body[p]
                if pq_tq >> 4:                           # 16-bit table
                    tab = np.frombuffer(body, ">u2", 64, p + 1).astype(np.int32)
                    p += 129
                else:
                    tab = np.frombuffer(body, np.uint8, 64, p + 1).astype(np.int32)
                    p += 65
                qt[pq_tq & 15] = tab
        elif marker == 0xDD:                             # DRI
            (restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:                             # SOS
            ns = body[0]
            if ns > 4:                                   # T.81 B.2.3: Ns <= 4
                raise JpegError(f"bad scan component count {ns}")
            comps_s = []
            for i in range(ns):
                cid = body[1 + 2 * i]
                td, ta = body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15
                # tables are snapshot at scan time (progressive streams
                # redefine DHT between scans)
                comps_s.append((cid, huff.get((0, td)), huff.get((1, ta))))
            ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            ent, rst_list, nxt = _extract_entropy(data, pos + 2 + seglen)
            scans.append({"comps": comps_s, "ss": ss, "se": se,
                          "ah": ahal >> 4, "al": ahal & 15, "ent": ent,
                          "rst": rst_list,
                          "restart_interval": restart_interval})
            pos = nxt
            continue
        pos += 2 + seglen
    if frame is None or not scans:
        raise JpegError("missing SOF/SOS")

    H, W, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcus_x = -(-W // (8 * hmax))
    mcus_y = -(-H // (8 * vmax))

    comp_state = {
        cid: {"h": ch, "v": cv, "q": qt[tq],
              "coef": np.zeros((mcus_y * cv, mcus_x * ch, 64), np.int32)}
        for cid, ch, cv, tq in comps
    }
    frame_dims = (W, H, hmax, vmax, mcus_x, mcus_y)
    for sc in scans:
        if not _decode_scan_native(sc, comp_state, frame_dims):
            _decode_scan(sc, comp_state, frame_dims)

    # ---- vectorised: dequantise, de-zigzag, IDCT, plane assembly ----
    planes = []
    for cid, ch, cv, tq in comps:
        ci = comp_state[cid]
        grid = ci["coef"]
        bhg, bwg = grid.shape[:2]
        coef = grid.reshape(-1, 64) * ci["q"][None, :]
        blocks = np.zeros((coef.shape[0], 64), np.float32)
        blocks[:, _ZIGZAG] = coef
        blocks = blocks.reshape(-1, 8, 8)
        spatial = np.einsum("ki,nkl,lj->nij", _C, blocks, _C,
                            optimize=True) + 128.0
        plane = (spatial.reshape(bhg, bwg, 8, 8)
                 .transpose(0, 2, 1, 3).reshape(bhg * 8, bwg * 8))
        # upsample to full MCU resolution (nearest — matches common fast paths)
        if ch < hmax:
            plane = np.repeat(plane, hmax // ch, axis=1)
        if cv < vmax:
            plane = np.repeat(plane, vmax // cv, axis=0)
        planes.append(plane[:H, :W])

    rgba = np.zeros((H, W, 4), np.uint8)
    rgba[..., 3] = 255
    if len(planes) == 1:
        g = np.clip(planes[0], 0, 255).astype(np.uint8)
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = g
    elif len(planes) == 3:
        y, cb, cr = planes
        r = y + 1.402 * (cr - 128.0)
        g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
        b = y + 1.772 * (cb - 128.0)
        rgba[..., 0] = np.clip(r, 0, 255).astype(np.uint8)
        rgba[..., 1] = np.clip(g, 0, 255).astype(np.uint8)
        rgba[..., 2] = np.clip(b, 0, 255).astype(np.uint8)
    else:
        raise JpegError(f"unsupported component count {len(planes)}")
    return rgba
