"""The port's image codec: PNG, baseline JPEG and Motion-JPEG AVI, with no
imaging library (the port's replacement for the cv2 calls of the JAX
package's replay, scripted capture, artifact saver and offline tools).

Arrays are numpy, channels in RGB order (cv2 reads and writes BGR):

  * ``read_png``/``write_png``: 8-bit gray, gray+alpha, RGB, RGBA and
    palette images, 16-bit gray/RGB(A) (samples big-endian in the file, as
    cv2 writes depth maps), 1/2/4-bit gray and palette on read. Deflate
    and inflate go through ``zlib``; filtering and unfiltering (all five
    filter types) through native/image_codec.cpp.
  * ``read_jpeg``/``write_jpeg``: baseline Huffman JPEG with restart
    markers, at 4:4:4, 4:2:2 and 4:2:0 (and gray). Decoding uses libjpeg's
    integer IDCT, fancy upsampling and colour tables, so a decoded image
    equals cv2.imdecode's bit for bit; ``write_jpeg`` defaults to cv2's
    quality 95 at 4:2:0, with the Annex K tables scaled by the IJG quality
    formula. Progressive and other non-baseline files are refused with an
    error that names their kind.
  * ``read_image`` dispatches on a file's magic bytes.
  * ``AviWriter``: Motion-JPEG frames in a RIFF AVI with an ``idx1``
    index, where the JAX package writes an mp4 through cv2's ``mp4v``
    encoder (no mp4 encoder is at hand here).

The serial stages (PNG filters, Huffman coding, the transforms) run in the
C++ library, built by native/build.py at first use; a failed build raises.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional, Tuple, Union

import numpy as np

Source = Union[str, bytes, bytearray, memoryview]

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"

# T.81 Annex K, natural (row-major) order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
CHROMA_QUANT = np.full(64, 99, np.int64)
CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# zigzag position -> natural index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# T.81 Annex K.3: (code counts by length 1..16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}
PNG_ZLIB_LEVEL = 1      # cv2.imwrite's default compression

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from naruto_tpu_torch.native.build import ensure_built

            lib = ctypes.CDLL(ensure_built("image_codec"))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            u16 = ctypes.POINTER(ctypes.c_uint16)
            ip = ctypes.POINTER(ctypes.c_int)
            c_int = ctypes.c_int
            lib.png_unfilter.restype = c_int
            lib.png_unfilter.argtypes = [u8, u8, c_int, c_int, c_int]
            lib.png_filter.restype = None
            lib.png_filter.argtypes = [u8, u8, c_int, c_int, c_int, c_int]
            lib.jpeg_decode.restype = c_int
            lib.jpeg_decode.argtypes = [
                u8, ctypes.c_int64, c_int, c_int, c_int, ip, ip, u16, ip, ip,
                u8, u8, c_int, c_int, u8]
            lib.jpeg_encode.restype = ctypes.c_int64
            lib.jpeg_encode.argtypes = [
                u8, c_int, c_int, c_int, c_int, c_int, u16, u8, u8, u8,
                ctypes.c_int64]
            _LIB = lib
    return _LIB


def _ptr(arr: np.ndarray, ctype=ctypes.c_uint8):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _read_source(src: Source) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------- PNG
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 or uint16 array: [H, W] gray, [H, W, 2] gray +
    alpha, [H, W, 3] RGB (palette images too), [H, W, 4] RGBA."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat = 8, []
    w = h = depth = ctype = None
    palette = None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            if interlace:
                raise ValueError("interlaced (Adam7) PNG is not supported")
            if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) \
                    or (depth == 16 and ctype == 3) \
                    or (depth < 8 and ctype not in (0, 3)):
                raise ValueError(f"unsupported PNG: colour type {ctype}, "
                                 f"bit depth {depth}")
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if w is None:
        raise ValueError("PNG without IHDR")
    ch = _PNG_CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    out = np.empty((h, stride), np.uint8)
    rc = _lib().png_unfilter(_ptr(np.ascontiguousarray(raw)), _ptr(out), h,
                             stride, bpp)
    if rc < 0:
        raise ValueError(f"bad PNG filter type on row {-rc - 1}")
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = out.reshape(h, w, ch)
    else:
        img = np.unpackbits(out, axis=1).reshape(h, stride * 8 // depth,
                                                 depth)[:, :w]
        img = (img * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        img = img.astype(np.uint8)[..., None]
        if ctype == 0:   # scale gray to 8 bits, as libpng's expansion
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def read_png(src: Source) -> np.ndarray:
    """A PNG file (path or bytes) -> array, as ``decode_png``."""
    return decode_png(_read_source(src))


def encode_png(img: np.ndarray, filter_type: Optional[int] = None) -> bytes:
    """uint8 or uint16 [H, W], [H, W, 2|3|4] (RGB order) -> PNG bytes,
    deflated at PNG_ZLIB_LEVEL. `filter_type` 0-4 filters every row with
    that type, None picks per row as libpng does."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"PNG takes [H, W] or [H, W, 2|3|4], not "
                         f"{img.shape}")
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    data = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    flat = data.view(np.uint8).reshape(h, -1)
    stride = flat.shape[1]
    raw = np.empty((h, stride + 1), np.uint8)
    mode = 5 if filter_type is None else int(filter_type)
    if not 0 <= mode <= 5:
        raise ValueError(f"PNG filter type {filter_type} is not 0..4")
    _lib().png_filter(_ptr(flat), _ptr(raw), h, stride, ch * depth // 8,
                      mode)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (PNG_MAGIC + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), PNG_ZLIB_LEVEL))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray,
              filter_type: Optional[int] = None) -> None:
    _write_file(path, encode_png(img, filter_type))


# --------------------------------------------------------------------- JPEG
_SOF_KINDS = {
    0xC1: "extended sequential", 0xC2: "progressive", 0xC3: "lossless",
    0xC5: "differential sequential", 0xC6: "differential progressive",
    0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 [H, W, 3] RGB, or [H, W] for a gray
    file; bit for bit libjpeg's decoding (ISLOW IDCT, fancy upsampling)."""
    if data[:2] != JPEG_MAGIC:
        raise ValueError("not a JPEG file")
    qt = np.zeros((4, 64), np.uint16)
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    frame = None
    restart = 0
    adobe_transform = None
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:          # fill byte
            pos -= 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            raise ValueError("JPEG ends before its scan")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:          # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    q = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    q = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                qt[tq, ZIGZAG] = q
        elif marker == 0xC4:        # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                total = int(counts.sum())
                slot = th + 4 * tc
                bits[slot] = counts
                vals[slot, :total] = np.frombuffer(
                    body[i + 17:i + 17 + total], np.uint8)
                i += 17 + total
        elif marker == 0xDD:        # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xC0:        # SOF0, baseline
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported")
            if h == 0 or w == 0 or len(body) < 6 + 3 * nc:
                raise ValueError(f"JPEG frame header of a {h}x{w} image "
                                 "is not supported")
            comps = [body[6 + 3 * k:9 + 3 * k] for k in range(nc)]
            frame = (h, w, [(c[0], c[1] >> 4, c[1] & 15, c[2])
                            for c in comps])
        elif marker in _SOF_KINDS:
            raise ValueError(f"{_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}"
                             f") is not supported: baseline only")
        elif marker == 0xDA:        # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            h, w, comps = frame
            ns = body[0]
            sel = {body[1 + 2 * k]: body[2 + 2 * k] for k in range(ns)}
            if ns != len(comps) or set(sel) != {c[0] for c in comps}:
                raise ValueError("JPEG with more than one scan is not "
                                 "supported: one interleaved scan only")
            if len(comps) not in (1, 3):
                raise ValueError(f"{len(comps)}-component JPEG is not "
                                 "supported")
            return _decode_scan(data[pos:], h, w, comps, sel, qt, bits, vals,
                                restart, adobe_transform)
    raise ValueError("JPEG without a scan")


def _decode_scan(scan, h, w, comps, sel, qt, bits, vals, restart,
                 adobe_transform) -> np.ndarray:
    nc = len(comps)
    hs = np.array([c[1] for c in comps], np.int32)
    vs = np.array([c[2] for c in comps], np.int32)
    quant = np.ascontiguousarray(qt[[c[3] for c in comps]])
    td = np.array([sel[c[0]] >> 4 for c in comps], np.int32)
    ta = np.array([sel[c[0]] & 15 for c in comps], np.int32)
    buf = np.frombuffer(scan, np.uint8)
    out = np.empty((h, w, nc), np.uint8)
    ycc = int(nc == 3 and adobe_transform != 0)
    ip = ctypes.c_int
    rc = _lib().jpeg_decode(
        _ptr(buf), len(buf), w, h, nc, _ptr(hs, ip), _ptr(vs, ip),
        _ptr(quant, ctypes.c_uint16), _ptr(td, ip), _ptr(ta, ip),
        _ptr(bits), _ptr(vals), restart, ycc, _ptr(out))
    if rc:
        raise ValueError({-1: "bad Huffman table",
                          -2: "bad Huffman code in the scan data",
                          -3: "missing restart marker",
                          -4: "unsupported sampling factors"}[rc]
                         + " in the JPEG")
    return out[..., 0] if nc == 1 else out


def read_jpeg(src: Source) -> np.ndarray:
    """A baseline JPEG file (path or bytes) -> array, as ``decode_jpeg``."""
    return decode_jpeg(_read_source(src))


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The Annex K tables scaled by the IJG quality formula (jcparam.c's
    jpeg_set_quality with force_baseline), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.uint16)
                 for t in (LUMA_QUANT, CHROMA_QUANT))


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95,
                sampling: str = "420") -> bytes:
    """uint8 [H, W, 3] RGB (or [H, W] gray) -> baseline JPEG bytes, laid out
    as libjpeg writes them (JFIF APP0, one DQT and DHT per table). The
    defaults are cv2.imwrite's: quality 95, 4:2:0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG takes uint8, not {img.dtype}")
    gray = img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1)
    if not gray and (img.ndim != 3 or img.shape[2] != 3):
        raise ValueError(f"JPEG takes [H, W] or [H, W, 3], not {img.shape}")
    if sampling not in SAMPLING:
        raise ValueError(f"sampling {sampling!r} is not one of "
                         f"{sorted(SAMPLING)}")
    img = np.ascontiguousarray(img.reshape(img.shape[:2]) if gray else img)
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG image is at most 65535 a side, not {h}x{w}")
    nc = 1 if gray else 3
    hs, vs = (1, 1) if gray else SAMPLING[sampling]
    luma, chroma = quality_tables(quality)
    tables = [(DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA)][:1 if gray else 2]
    bits = np.zeros((2, 2, 16), np.uint8)
    vals = np.zeros((2, 2, 256), np.uint8)
    for t, pair in enumerate(tables):
        for k, (counts, syms) in enumerate(pair):
            bits[t, k] = counts
            vals[t, k, :len(syms)] = list(syms)
    qt = np.ascontiguousarray(np.stack([luma, chroma, chroma]))
    cap = h * w * nc * 2 + 4096
    out = np.empty(cap, np.uint8)
    size = _lib().jpeg_encode(
        _ptr(img), w, h, nc, hs, vs, _ptr(qt, ctypes.c_uint16), _ptr(bits),
        _ptr(vals), _ptr(out), cap)
    if size < 0:
        raise RuntimeError("JPEG encoder's buffer was too small")
    head = [b"\xff\xd8",
            _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate((luma, chroma)[:len(tables)]):
        head.append(_segment(0xDB, bytes([t]) + q[ZIGZAG].astype(
            np.uint8).tobytes()))
    comps = [(1, hs, vs, 0), (2, 1, 1, 1), (3, 1, 1, 1)][:nc]
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([cid, (ch << 4) | cv, tq]) for cid, ch, cv, tq in comps)))
    for t, pair in enumerate(tables):
        for k, (counts, syms) in enumerate(pair):
            head.append(_segment(0xC4, bytes([(k << 4) | t]) + bytes(counts)
                                 + bytes(syms)))
    head.append(_segment(0xDA, bytes([nc]) + b"".join(
        bytes([cid, (tq << 4) | tq]) for cid, _, _, tq in comps)
        + b"\x00\x3f\x00"))
    return b"".join(head) + out[:size].tobytes() + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               sampling: str = "420") -> None:
    _write_file(path, encode_jpeg(img, quality, sampling))


def as_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded image -> [H, W, 3] of its dtype, as cv2's IMREAD_COLOR
    takes it: gray (with or without alpha) copied to three channels, alpha
    dropped."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def read_image(src: Source) -> np.ndarray:
    """A PNG or JPEG file (path or bytes), by its magic bytes."""
    data = _read_source(src)
    if data[:8] == PNG_MAGIC:
        return decode_png(data)
    if data[:2] == JPEG_MAGIC:
        return decode_jpeg(data)
    what = src if isinstance(src, str) else "data"
    raise ValueError(f"{what}: neither PNG nor JPEG")


# ---------------------------------------------------------------------- AVI
class AviWriter:
    """Motion-JPEG in a RIFF AVI (``00dc`` chunks under ``movi``, an
    ``idx1`` index with offsets relative to ``movi``), the port's stand-in
    for cv2.VideoWriter with ``mp4v``. Frames are uint8 [h, w, 3] RGB,
    each encoded at ``encode_jpeg``'s defaults.

        with AviWriter("run.avi", fps=10, size=(w, h)) as vw:
            vw.write(frame)
    """

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        if not str(path).lower().endswith(".avi"):
            raise ValueError(
                f"{path}: AviWriter writes Motion-JPEG AVI files, so the "
                "path must end in .avi (the port has no mp4 encoder)")
        self.path = path
        self.fps = float(fps)
        self.w, self.h = (int(size[0]), int(size[1]))
        self._index = []           # (offset from 'movi', size)
        self._f = open(path, "wb")
        self._f.write(self._header(final=False))
        self._movi_at = self._f.tell() - 4   # the 'movi' fourcc

    def _header(self, final: bool) -> bytes:
        n = len(self._index)
        biggest = max((s for _, s in self._index), default=0)
        rate, scale = int(round(self.fps * 1000)), 1000
        avih = struct.pack(
            "<IIIIIIIIII16x", int(round(1e6 / self.fps)), 0, 0, 0x10, n, 0,
            1, biggest, self.w, self.h)
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, scale,
            rate, 0, n, biggest, 0xFFFFFFFF, 0, 0, 0, self.w, self.h)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.w, self.h, 1, 24,
                           b"MJPG", self.w * self.h * 3, 0, 0, 0, 0)
        strl = (b"strl" + self._chunk(b"strh", strh)
                + self._chunk(b"strf", strf))
        hdrl = (b"hdrl" + self._chunk(b"avih", avih)
                + self._list(strl))
        movi_size = 4 + sum(8 + s + (s & 1) for _, s in self._index)
        riff_size = (4 + 8 + len(hdrl) + 8 + movi_size
                     + (8 + 16 * n if final else 0))
        return (struct.pack("<4sI4s", b"RIFF", riff_size, b"AVI ")
                + self._list(hdrl)
                + struct.pack("<4sI4s", b"LIST", movi_size, b"movi"))

    @staticmethod
    def _chunk(fourcc: bytes, body: bytes) -> bytes:
        pad = b"\x00" if len(body) & 1 else b""
        return struct.pack("<4sI", fourcc, len(body)) + body + pad

    @staticmethod
    def _list(body: bytes) -> bytes:
        return struct.pack("<4sI", b"LIST", len(body)) + body

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.shape != (self.h, self.w, 3) or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype} is not "
                             f"uint8 ({self.h}, {self.w}, 3)")
        jpg = encode_jpeg(frame)
        self._index.append((self._f.tell() - self._movi_at, len(jpg)))
        self._f.write(self._chunk(b"00dc", jpg))

    def close(self) -> None:
        if self._f.closed:
            return
        idx = b"".join(struct.pack("<4sIII", b"00dc", 0x10, off, size)
                       for off, size in self._index)
        self._f.write(self._chunk(b"idx1", idx))
        head = self._header(final=True)
        self._f.seek(0)
        self._f.write(head)
        self._f.close()

    @property
    def frames(self) -> int:
        return len(self._index)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avi_frames(path: str):
    """The frames of an MJPEG AVI (as AviWriter writes), decoded: a list of
    uint8 [h, w, 3]. Reads the ``idx1`` index."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    movi = data.find(b"movi")
    idx = data.rfind(b"idx1")
    if movi < 0 or idx < 0:
        raise ValueError(f"{path}: AVI without movi or idx1")
    n = struct.unpack("<I", data[idx + 4:idx + 8])[0] // 16
    frames = []
    for k in range(n):
        _, _, off, size = struct.unpack(
            "<4sIII", data[idx + 8 + 16 * k:idx + 24 + 16 * k])
        start = movi + off + 8
        frames.append(decode_jpeg(data[start:start + size]))
    return frames


__all__ = ["read_png", "write_png", "encode_png", "decode_png", "read_jpeg",
           "write_jpeg", "encode_jpeg", "decode_jpeg", "as_rgb", "read_image",
           "quality_tables", "AviWriter", "read_avi_frames"]
