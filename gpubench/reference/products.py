"""A simulation's product read back from disk, for the check.

A cell that writes its product (`"product": {"fmt": "fits"}` in its
workload file) is judged by the file, not by the arrays still in memory:
a deployment's guarantee is that the data set it wrote is correct. This is
a plain FITS reader of the port's native-schema product, written from the
FITS standard and the schema alone: 2880-byte blocks of 80-character
cards, big-endian IMAGE extensions found by EXTNAME, and the LST column of
the "POINTING AND PHASE CENTER INFO" binary table. It imports nothing of
the program.

`read_sample(path, idx)` gives what `check.keep_sample` gives of a
VisibilitySet in memory, key for key: the sample cubes of the sky
visibilities, the visibilities and the noise (complex64, as the file
holds float32 parts), the noise power of every channel over the whole
noise cube, the projected baselines, the noise rms on the sample, and the
LST of every accumulation. It raises ValueError (or OSError) on a file
that is missing, truncated or not such a product.
"""

from __future__ import annotations

import os

import numpy as np

BLOCK = 2880
CARD = 80
POINTING = "POINTING AND PHASE CENTER INFO"
# the cubes of the sample, (B, C, T) images of float32 parts
CUBES = {"skyvis": "freq_sky_visibility", "vis": "freq_obs_visibility",
         "noise": "freq_noise_visibility"}
# bytes of one element of a binary-table column, by its TFORM code
_TFORM_BYTES = {"L": 1, "X": 1, "B": 1, "I": 2, "J": 4, "K": 8, "A": 1,
                "E": 4, "D": 8, "C": 8, "M": 16}
_BITPIX = {8: "u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4",
           -64: ">f8"}


def _value(raw):
    """The value of a card's columns 11-80: a string, a logical, an
    integer or a real; the text itself where it is none of them."""
    raw = raw.strip()
    if raw.startswith("'"):
        return raw[1:].split("'")[0].rstrip()
    raw = raw.split("/")[0].strip()
    if raw in ("T", "F"):
        return raw == "T"
    for kind in (int, float):
        try:
            return kind(raw.replace("D", "E"))
        except ValueError:
            pass
    return raw


def _header(fh):
    """The next header's cards {key: value}; None at the end of the
    file."""
    cards = {}
    while True:
        block = fh.read(BLOCK)
        if not block:
            if cards:
                raise ValueError("a header without END")
            return None
        if len(block) < BLOCK:
            raise ValueError("a truncated header block")
        text = block.decode("ascii")
        for i in range(0, BLOCK, CARD):
            card = text[i:i + CARD]
            key = card[:8].strip()
            if key == "END":
                return cards
            if card[8:10] == "= ":
                cards[key] = _value(card[10:])


def _data_bytes(h):
    naxis = int(h.get("NAXIS", 0))
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= int(h["NAXIS%d" % i])
    return abs(int(h["BITPIX"])) // 8 * int(h.get("GCOUNT", 1)) * (
        int(h.get("PCOUNT", 0)) + n)


def extensions(path):
    """{EXTNAME: (header, offset of its data in bytes)} of every extension
    of the file; ValueError where a header or its data runs past the end
    of the file."""
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as fh:
        while True:
            h = _header(fh)
            if h is None:
                return out
            start = fh.tell()
            n = _data_bytes(h)
            if start + n > size:
                raise ValueError("%s: %s ends past the end of the file"
                                 % (path, h.get("EXTNAME", "an HDU")))
            if "EXTNAME" in h:
                out[str(h["EXTNAME"])] = (h, start)
            fh.seek(start + (n + BLOCK - 1) // BLOCK * BLOCK)


def _image(path, ext, name):
    """The IMAGE extension `name` as a read-only map, numpy axis order
    (the last FITS axis first)."""
    if name not in ext:
        raise ValueError("%s: no image %r" % (path, name))
    h, start = ext[name]
    if str(h.get("XTENSION", "")).strip() != "IMAGE":
        raise ValueError("%s: %r is not an image" % (path, name))
    shape = tuple(int(h["NAXIS%d" % i])
                  for i in range(int(h["NAXIS"]), 0, -1))
    return np.memmap(path, dtype=_BITPIX[int(h["BITPIX"])], mode="r",
                     offset=start, shape=shape)


def _column(path, ext, table, column):
    """One numeric column of a binary table, as float64."""
    if table not in ext:
        raise ValueError("%s: no table %r" % (path, table))
    h, start = ext[table]
    rows, width = int(h["NAXIS2"]), int(h["NAXIS1"])
    at = 0
    for i in range(1, int(h["TFIELDS"]) + 1):
        tform = str(h["TFORM%d" % i]).strip()
        rep = int(tform[:-1]) if tform[:-1] else 1
        if str(h["TTYPE%d" % i]).strip() == column:
            if tform[-1] not in "DE":
                raise ValueError("%s: %s.%s is %s" % (path, table, column,
                                                      tform))
            dt = ">f8" if tform[-1] == "D" else ">f4"
            raw = np.memmap(path, dtype="u1", mode="r", offset=start,
                            shape=(rows, width))
            return np.ascontiguousarray(
                raw[:, at:at + rep * np.dtype(dt).itemsize]).view(dt) \
                .reshape(rows * rep).astype(np.float64)
        at += rep * _TFORM_BYTES[tform[-1]]
    raise ValueError("%s: no column %s in %r" % (path, column, table))


def _complex(path, ext, stem):
    """The (re, im) float32 maps of a complex cube."""
    re = _image(path, ext, "real_" + stem)
    im = _image(path, ext, "imag_" + stem)
    if re.shape != im.shape:
        raise ValueError("%s: the parts of %s differ in shape" % (path, stem))
    return re, im


def _cut(re, im, cut):
    out = np.empty(re[cut].shape, np.complex64)
    out.real = re[cut]
    out.imag = im[cut]
    return out


def read_sample(path, idx):
    """What the comparison reads of the product at `path`: the dict of
    `check.keep_sample` for the sample `idx` (baselines, channels and
    accumulations)."""
    ext = extensions(path)
    cut = np.ix_(idx["bl"], idx["ch"], idx["t"])
    got = {}
    for key, stem in CUBES.items():
        re, im = _complex(path, ext, stem)
        got[key] = _cut(re, im, cut)
    re, im = (np.asarray(x, np.float32) for x in
              _complex(path, ext, CUBES["noise"]))
    got["noise_power"] = (re ** 2 + im ** 2).mean(axis=(0, 2),
                                                   dtype=np.float64)
    got["noise_count"] = re.size
    got["uvw"] = np.array(_image(path, ext, "proj_baselines"), np.float64)
    got["rms"] = np.asarray(_image(
        path, ext, "freq_channel_noise_rms_visibility")[cut], np.float64)
    got["lst"] = _column(path, ext, POINTING, "LST")
    return got
