"""Minimal pure-numpy FITS binary-table I/O.

The reference stores spectral grids in FITS files written by astropy
(python/sim5fitstable.py:61-99): a PrimaryHDU plus BINTABLE extensions
whose columns use the TFORM codes A (chars), J (int32), E (float32),
D (float64) and the variable-length descriptor P (heap arrays, used for
the META 'GRID' column).  astropy is not a dependency of this package, so
this module implements exactly that subset of the FITS standard -- enough
to round-trip the reference's table layout byte-compatibly: 2880-byte
header/data blocks, 80-char ASCII cards, big-endian table data, and the
PCOUNT heap for 'P' columns.

Not a general FITS library: no images, no scaling keywords, no ASCII
tables, no compression.

Port of `sim5_tpu/utils/fitsio.py`, a copy: the port keeps its own, so
that its tables write the same bytes as the JAX package's.
"""

import re

import numpy as np

BLOCK = 2880
_TFORM_RE = re.compile(r"^(\d*)([LABIJKED])$")
_TFORM_P_RE = re.compile(r"^(\d*)P([ABIJKED])\((\d+)\)$")
_BASE_DTYPE = {"L": "S1", "A": "S1", "B": "u1", "I": ">i2", "J": ">i4",
               "K": ">i8", "E": ">f4", "D": ">f8"}
_BASE_SIZE = {"L": 1, "A": 1, "B": 1, "I": 2, "J": 4, "K": 8, "E": 4, "D": 8}


# --------------------------------------------------------------------------
# header cards
# --------------------------------------------------------------------------

def _format_value(v):
    """FITS fixed-format card value field (standard section 4.2)."""
    if isinstance(v, bool):
        return "T".rjust(20) if v else "F".rjust(20)
    if isinstance(v, (int, np.integer)):
        return str(int(v)).rjust(20)
    if isinstance(v, (float, np.floating)):
        s = repr(float(v))
        return s.rjust(20)
    s = str(v).replace("'", "''")
    return ("'" + s.ljust(8) + "'").ljust(20)


def _card(key, value=None, comment=None):
    if value is None:
        line = key.ljust(80)
    else:
        line = key.ljust(8) + "= " + _format_value(value)
        if comment:
            line += " / " + comment
    line = line[:80].ljust(80)
    return line.encode("ascii")


def _parse_value(field):
    """Parse a card's value+comment field into a python value."""
    field = field.strip()
    if field.startswith("'"):
        # string: closing quote with '' escapes
        out, i = [], 1
        while i < len(field):
            if field[i] == "'":
                if i + 1 < len(field) and field[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(field[i])
            i += 1
        return "".join(out).rstrip()
    field = field.split("/", 1)[0].strip()
    if field in ("T", "F"):
        return field == "T"
    try:
        return int(field)
    except ValueError:
        pass
    try:
        return float(field)
    except ValueError:
        return field


def _read_header(f):
    """Read 2880-blocks of cards up to END; returns an ordered dict."""
    header = {}
    while True:
        block = f.read(BLOCK)
        if len(block) == 0 and not header:
            return None  # clean EOF between HDUs
        if len(block) < BLOCK:
            raise IOError("truncated FITS header")
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                return header
            if not key or card[8:10] != "= ":
                continue  # COMMENT/HISTORY/blank
            header[key] = _parse_value(card[10:])


def _write_header(f, cards):
    """cards: list of (key, value, comment) or (key,) for bare keywords."""
    buf = b"".join(_card(*c) for c in cards) + _card("END")
    pad = (-len(buf)) % BLOCK
    f.write(buf + b" " * pad)


# --------------------------------------------------------------------------
# binary tables
# --------------------------------------------------------------------------

class Column:
    """One binary-table column.

    format: FITS TFORM -- e.g. '16A', '1J', '1E', '8E', '1PE' (variable).
    array:  per-row values; for 'P' formats a list of 1-D arrays.
    """

    def __init__(self, name, format, array):
        self.name = name
        self.format = format
        self.array = array


class BinTable:
    def __init__(self, name, columns, header=None):
        self.name = name
        self.columns = columns
        self.header = dict(header or {})

    def __getitem__(self, colname):
        for c in self.columns:
            if c.name == colname:
                return c.array
        raise KeyError(colname)

    @property
    def names(self):
        return [c.name for c in self.columns]


def _col_width(fmt):
    m = _TFORM_P_RE.match(fmt) or re.match(r"^(\d*)P([A-Z])$", fmt)
    if m:
        return 8  # (count, offset) int32 pair
    m = _TFORM_RE.match(fmt)
    if not m:
        raise IOError(f"unsupported TFORM {fmt!r}")
    r = int(m.group(1) or 1)
    return r * _BASE_SIZE[m.group(2)]


def _encode_table(table):
    """Build (header_cards, payload_bytes) for one BINTABLE HDU."""
    ncols = len(table.columns)
    nrows = len(table.columns[0].array) if ncols else 0
    widths = [_col_width(c.format) for c in table.columns]
    naxis1 = sum(widths)

    heap = bytearray()
    rowdata = [bytearray() for _ in range(nrows)]
    formats = []
    for c, w in zip(table.columns, widths):
        mp = _TFORM_P_RE.match(c.format) or re.match(r"^(\d*)P([A-Z])$",
                                                     c.format)
        if mp:
            code = mp.group(2)
            maxlen = 0
            descs = []
            for v in c.array:
                v = np.asarray(v, _BASE_DTYPE[code])
                descs.append((len(v), len(heap)))
                heap.extend(v.tobytes())
                maxlen = max(maxlen, len(v))
            formats.append(f"1P{code}({maxlen})")
            for row, (n, off) in zip(rowdata, descs):
                row.extend(np.array([n, off], ">i4").tobytes())
            continue
        formats.append(c.format)
        m = _TFORM_RE.match(c.format)
        r, code = int(m.group(1) or 1), m.group(2)
        if code == "A":
            vals = np.asarray(c.array, f"S{r}")
            for row, v in zip(rowdata, vals):
                row.extend(v.ljust(r))
        else:
            vals = np.asarray(c.array, _BASE_DTYPE[code]).reshape(nrows, r)
            for row, v in zip(rowdata, vals):
                row.extend(v.tobytes())

    body = b"".join(bytes(r) for r in rowdata)
    assert len(body) == naxis1 * nrows
    payload = body + bytes(heap)
    cards = [("XTENSION", "BINTABLE", "binary table extension"),
             ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", naxis1),
             ("NAXIS2", nrows), ("PCOUNT", len(heap)), ("GCOUNT", 1),
             ("TFIELDS", ncols)]
    for i, (c, fmt) in enumerate(zip(table.columns, formats), 1):
        cards.append((f"TTYPE{i}", c.name))
        cards.append((f"TFORM{i}", fmt))
    cards.append(("EXTNAME", table.name))
    for k, v in table.header.items():
        cards.append((k, v))
    return cards, payload


def _decode_table(header, payload):
    naxis1 = header["NAXIS1"]
    nrows = header["NAXIS2"]
    ncols = header["TFIELDS"]
    theap = header.get("THEAP", naxis1 * nrows)
    body = payload[:naxis1 * nrows]
    heap = payload[theap:]

    columns = []
    offset = 0
    for i in range(1, ncols + 1):
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        fmt = str(header[f"TFORM{i}"]).strip()
        w = _col_width(fmt)
        colbytes = b"".join(body[r * naxis1 + offset:
                                 r * naxis1 + offset + w]
                            for r in range(nrows))
        mp = _TFORM_P_RE.match(fmt) or re.match(r"^(\d*)P([A-Z])$", fmt)
        if mp:
            code = mp.group(2)
            desc = np.frombuffer(colbytes, ">i4").reshape(nrows, 2)
            sz = _BASE_SIZE[code]
            vals = [np.frombuffer(heap[off:off + n * sz],
                                  _BASE_DTYPE[code]).copy()
                    for n, off in desc]
        else:
            m = _TFORM_RE.match(fmt)
            r, code = int(m.group(1) or 1), m.group(2)
            if code == "A":
                vals = np.frombuffer(colbytes, f"S{r}")
                vals = np.char.decode(vals, "ascii")
                vals = np.char.strip(vals)
            else:
                vals = np.frombuffer(colbytes, _BASE_DTYPE[code])
                vals = vals.reshape(nrows, r) if r > 1 else vals
                vals = vals.copy()
        columns.append(Column(name, fmt, vals))
        offset += w
    return BinTable(str(header.get("EXTNAME", "")).strip(), columns, header)


# --------------------------------------------------------------------------
# file API
# --------------------------------------------------------------------------

def write_fits(path, tables, primary_header=None):
    """Write a FITS file: empty primary HDU (+ extra header cards) followed
    by one BINTABLE extension per `BinTable`."""
    with open(path, "wb") as f:
        cards = [("SIMPLE", True, "conforms to FITS standard"),
                 ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True)]
        for k, v in (primary_header or {}).items():
            cards.append((k, v))
        _write_header(f, cards)
        for t in tables:
            cards, payload = _encode_table(t)
            _write_header(f, cards)
            f.write(payload + b"\x00" * ((-len(payload)) % BLOCK))


def read_fits(path):
    """Read a FITS file -> (primary_header, {EXTNAME: BinTable}).

    Parses the subset written by `write_fits` and by the reference's
    astropy-based writer (BINTABLE extensions incl. variable-length 'P'
    heap columns); image extensions are skipped.
    """
    tables = {}
    with open(path, "rb") as f:
        primary = _read_header(f)
        if primary is None or not primary.get("SIMPLE", False):
            raise IOError(f"{path}: not a FITS file")
        # primary data (if any) -- skip
        if primary.get("NAXIS", 0) > 0:
            nbytes = abs(primary["BITPIX"]) // 8
            for i in range(primary["NAXIS"]):
                nbytes *= primary[f"NAXIS{i + 1}"]
            f.seek((nbytes + BLOCK - 1) // BLOCK * BLOCK, 1)
        while True:
            header = _read_header(f)
            if header is None:
                break
            nbytes = header.get("NAXIS1", 0) * header.get("NAXIS2", 0) \
                + header.get("PCOUNT", 0)
            for i in range(3, header.get("NAXIS", 0) + 1):
                nbytes *= header[f"NAXIS{i}"]
            payload = f.read((nbytes + BLOCK - 1) // BLOCK * BLOCK)[:nbytes]
            if header.get("XTENSION", "").strip() == "BINTABLE":
                t = _decode_table(header, payload)
                tables[t.name] = t
    return primary, tables
