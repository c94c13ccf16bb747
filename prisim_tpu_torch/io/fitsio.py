"""Minimal pure-numpy FITS writer/reader (random groups, binary tables,
images).

Counterpart of prisim_tpu/io/fitsio.py for the UVFITS and native FITS
products, the catalog skies (NVSS, GLEAM and DSM/GSM per-pixel tables),
the HI cubes, the PFB tables and the external HEALPix beams: 2880-byte
header and data blocks, big-endian data, random-groups primary HDUs,
BINTABLE and IMAGE extensions. It imports no jax, where importing
prisim_tpu.io.fitsio runs prisim_tpu/io/__init__.py, which does.

`write_bintable` writes the same bytes as the reference's, from one
structured array rather than row by row (a DSM table at nside 256 has
786,432 rows), and keeps the big-endian byte order of a column whose
rows are resized to the tform repeat, where the reference's writes them
native-endian (ROADMAP R6).
"""

from __future__ import annotations

import numpy as np

__all__ = ["card", "format_header", "write_random_groups",
           "write_bintable", "write_image", "read_fits"]

BLOCK = 2880

# binary-table column codes other than 'A' (characters) -> big-endian dtype
_TFORM_DTYPE = {"E": ">f4", "D": ">f8", "J": ">i4", "I": ">i2", "K": ">i8"}
_BITPIX = {16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


def _fmt_value(v):
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return "%d" % v
    if isinstance(v, (float, np.floating)):
        s = "%.15G" % v
        if "." not in s and "E" not in s and "N" not in s:
            s += "."
        return s
    s = str(v).replace("'", "''")
    return "'%-8s'" % s


def card(key, value=None, comment=None):
    """One 80-char FITS header card: KEY = value [/ comment], a COMMENT or
    HISTORY card, or a bare keyword."""
    key = key.upper()[:8]
    if value is None and comment is None:
        return "%-80s" % key
    if key in ("COMMENT", "HISTORY"):
        return "%-80s" % (key + " " + (str(value) if value else ""))
    vs = _fmt_value(value)
    if vs.startswith("'"):
        body = "%-8s= %-20s" % (key, vs)
    else:
        body = "%-8s= %20s" % (key, vs)
    if comment:
        body += " / " + comment
    return "%-80s" % body[:80]


def format_header(cards):
    """cards: list of 80-char strings (append END, pad to block)."""
    text = "".join(cards) + "%-80s" % "END"
    pad = (-len(text)) % BLOCK
    return (text + " " * pad).encode("ascii")


def _pad_data(buf):
    return buf + b"\x00" * ((-len(buf)) % BLOCK)


def write_random_groups(fh, pars, data, header_cards):
    """Write a random-groups primary HDU.

    pars: (GCOUNT, PCOUNT) group parameters; data: (GCOUNT, ...) per-group
    data; both written as big-endian float32, each group its parameters
    then its data. header_cards must hold SIMPLE, BITPIX, NAXIS*, GROUPS,
    PCOUNT, GCOUNT, PTYPE* and the rest that match them."""
    fh.write(format_header(header_cards))
    pars = np.ascontiguousarray(pars, dtype=">f4")
    gcount, pcount = pars.shape
    rec = np.empty((gcount, pcount + int(np.prod(np.shape(data)[1:]))),
                   dtype=">f4")
    rec[:, :pcount] = pars
    rec[:, pcount:] = np.asarray(data).reshape(gcount, -1)
    fh.write(_pad_data(rec.tobytes()))


def _repeat(tform):
    return int(tform[:-1]) if tform[:-1] else 1


def write_bintable(fh, extname, columns, extra_cards=()):
    """Write a BINTABLE extension.

    columns: list of (name, tform, array) where tform like '8A', '3D',
    '1J', '1E'; array shape (nrows,) or (nrows, repeat)."""
    nrows = len(columns[0][2])
    fields, values = [], []
    for i, (name, tform, arr) in enumerate(columns):
        rep, code = _repeat(tform), tform[-1]
        if code == "A":
            fields.append(("f%d" % i, "S%d" % rep))
            values.append(np.array([str(x)[:rep].ljust(rep) for x in arr],
                                   dtype="S%d" % rep))
            continue
        dt = _TFORM_DTYPE[code]
        a = np.asarray(arr, dtype=dt).reshape(nrows, -1)
        if a.shape[1] != rep:
            a = np.stack([np.resize(row, rep) for row in a])
        fields.append(("f%d" % i, dt, (rep,)))
        values.append(a)
    table = np.empty(nrows, dtype=np.dtype(fields))
    for (fname, *_), v in zip(fields, values):
        table[fname] = v
    cards = [
        card("XTENSION", "BINTABLE", "binary table extension"),
        card("BITPIX", 8), card("NAXIS", 2),
        card("NAXIS1", table.dtype.itemsize), card("NAXIS2", nrows),
        card("PCOUNT", 0), card("GCOUNT", 1),
        card("TFIELDS", len(columns)),
    ]
    for i, (name, tform, _) in enumerate(columns, 1):
        cards.append(card("TTYPE%d" % i, name))
        cards.append(card("TFORM%d" % i, tform))
    cards.append(card("EXTNAME", extname))
    cards.extend(extra_cards)
    fh.write(format_header(cards))
    fh.write(_pad_data(table.tobytes()))


def write_image(fh, data=None, primary=False, extname=None,
                extra_cards=()):
    """Write an IMAGE HDU (primary or extension). data: ndarray or None
    (header-only HDU). Axis order follows FITS convention (NAXIS1 is the
    FASTEST-varying axis = the last numpy axis)."""
    cards = []
    if primary:
        cards.append(card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(card("XTENSION", "IMAGE", "image extension"))
    if data is None:
        cards += [card("BITPIX", 8), card("NAXIS", 0)]
        if not primary:
            cards += [card("PCOUNT", 0), card("GCOUNT", 1)]
    else:
        data = np.asarray(data)
        if data.dtype.kind == "f":
            dt, bitpix = (">f8", -64) if data.itemsize == 8 else \
                (">f4", -32)
        else:
            dt, bitpix = ">i4", 32
        cards += [card("BITPIX", bitpix), card("NAXIS", data.ndim)]
        for i, n in enumerate(reversed(data.shape), 1):
            cards.append(card("NAXIS%d" % i, int(n)))
        if not primary:
            cards += [card("PCOUNT", 0), card("GCOUNT", 1)]
    if extname:
        cards.append(card("EXTNAME", extname))
    cards.extend(extra_cards)
    fh.write(format_header(cards))
    if data is not None:
        fh.write(_pad_data(np.ascontiguousarray(data, dtype=dt)
                           .tobytes()))


def _parse_header(fh):
    cards = {}
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            return None
        text = block.decode("ascii", errors="replace")
        for i in range(0, BLOCK, 80):
            c = text[i:i + 80]
            if c[:8].strip() == "END":
                return cards
            if "=" not in c[8:10]:
                continue
            raw = c[10:].split(" / ")[0].strip()
            if raw.startswith("'"):
                val = raw[1:raw.rfind("'")].replace("''", "'").rstrip()
            elif raw in ("T", "F"):
                val = raw == "T"
            else:
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
            cards[c[:8].strip()] = val


def _read_blocks(fh, nbytes):
    return fh.read(((nbytes + BLOCK - 1) // BLOCK) * BLOCK)[:nbytes]


def read_fits(path):
    """Parse a FITS file: a list of HDUs, each a dict with 'header' and,
    for a random-groups HDU, 'pars' (GCOUNT, PCOUNT) float64 and 'data'
    (GCOUNT, NAXISn, ..., NAXIS2) float32; for a binary table, 'columns'
    (name -> array); for an image, 'data'."""
    hdus = []
    with open(path, "rb") as fh:
        while True:
            hdr = _parse_header(fh)
            if hdr is None:
                break
            if hdr.get("GROUPS") and hdr.get("GCOUNT", 0) >= 1:
                gcount, pcount = hdr["GCOUNT"], hdr["PCOUNT"]
                dims = [hdr["NAXIS%d" % i]
                        for i in range(2, hdr["NAXIS"] + 1)]
                per_group = int(np.prod(dims)) if dims else 0
                n = gcount * (pcount + per_group)
                arr = np.frombuffer(_read_blocks(fh, n * 4), dtype=">f4")
                arr = arr.reshape(gcount, pcount + per_group)
                hdus.append(dict(
                    header=hdr, pars=arr[:, :pcount].astype(np.float64),
                    data=arr[:, pcount:].reshape([gcount] + dims[::-1])
                    .astype(np.float32)))
                continue
            if str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
                nrows, row_bytes = hdr["NAXIS2"], hdr["NAXIS1"]
                fields = []
                for i in range(1, hdr["TFIELDS"] + 1):
                    tform = str(hdr["TFORM%d" % i]).strip()
                    name = str(hdr["TTYPE%d" % i]).strip()
                    rep, code = _repeat(tform), tform[-1]
                    if code == "A":
                        fields.append((name, "S%d" % rep))
                    elif rep == 1:
                        fields.append((name, _TFORM_DTYPE[code]))
                    else:
                        fields.append((name, _TFORM_DTYPE[code], (rep,)))
                dt = np.dtype(fields)
                table = np.frombuffer(_read_blocks(fh, nrows * row_bytes),
                                      dtype=dt)
                hdus.append(dict(header=hdr, columns={
                    name: table[name] for name in dt.names}))
                continue
            out = dict(header=hdr)
            naxis = hdr.get("NAXIS", 0)
            if naxis:
                dims = [hdr.get("NAXIS%d" % i, 0) for i in range(1, naxis + 1)]
                bitpix = hdr.get("BITPIX", 8)
                nbytes = abs(bitpix) // 8 * int(np.prod(dims))
                raw = _read_blocks(fh, nbytes)
                if bitpix in _BITPIX and nbytes:
                    out["data"] = np.frombuffer(
                        raw, dtype=_BITPIX[bitpix]).reshape(dims[::-1])
            hdus.append(out)
    return hdus
