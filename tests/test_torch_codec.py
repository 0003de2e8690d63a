"""The port's image codec (utils/image_io.py, native/image_codec.cpp) and
rasteriser (visualization/raster.py) against the libraries they replace:
cv2 (libpng, libjpeg-turbo, its MJPEG reader and INTER_LINEAR resize) and
matplotlib's jet, on small images made from a seed."""
import numpy as np
import pytest
import torch

from naruto_tpu_torch.utils import image_io
from naruto_tpu_torch.visualization import raster

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

PNG_KINDS = {
    "gray8": ((13, 17), np.uint8),
    "rgb8": ((13, 17, 3), np.uint8),
    "rgba8": ((11, 9, 4), np.uint8),
    "gray16": ((13, 17), np.uint16),
    "rgb16": ((9, 5, 3), np.uint16),
}
CV2_FILTERS = ("FILTER_NONE", "FILTER_SUB", "FILTER_UP", "FILTER_AVG",
               "FILTER_PAETH", "ALL_FILTERS")
SAMPLINGS = {"444": "IMWRITE_JPEG_SAMPLING_FACTOR_444",
             "422": "IMWRITE_JPEG_SAMPLING_FACTOR_422",
             "420": "IMWRITE_JPEG_SAMPLING_FACTOR_420"}
# odd sizes, sizes beside an MCU multiple, one block high
JPEG_SIZES = ((37, 53), (16, 16), (8, 24), (81, 130))


def png_image(kind, seed=0):
    shape, dtype = PNG_KINDS[kind]
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    noise = rng.integers(0, top // 7, shape, dtype=np.int64, endpoint=True)
    ramp = np.arange(shape[1]).reshape(1, -1, *([1] * (len(shape) - 2)))
    return ((noise + ramp * (top // 40)) % (top + 1)).astype(dtype)


def to_bgr(img):
    """RGB(A) -> cv2's BGR(A) channel order."""
    if img.ndim == 3 and img.shape[2] == 3:
        return img[..., ::-1]
    if img.ndim == 3 and img.shape[2] == 4:
        return img[..., [2, 1, 0, 3]]
    return img


def photo(h, w, seed=0):
    """A smooth RGB test image with noise (uint8)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 13.0),
                    128 + 90 * np.cos(x / 5.0 - y / 9.0),
                    (x * 3 + y * 2) % 256], axis=-1)
    img = img + rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------- PNG
@pytest.mark.parametrize("kind", list(PNG_KINDS))
def test_png_written_by_port_reads_in_cv2(tmp_path, kind):
    """Every filter type (and the adaptive choice) the port writes decodes
    in cv2 (libpng) to the same array, exactly."""
    img = png_image(kind)
    for ftype in (None, 0, 1, 2, 3, 4):
        path = str(tmp_path / "port.png")
        image_io.write_png(path, img, filter_type=ftype)
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, to_bgr(img), err_msg=str(ftype))
        assert got.dtype == img.dtype


@pytest.mark.parametrize("kind", list(PNG_KINDS))
def test_png_written_by_cv2_reads_in_port(tmp_path, kind):
    """Files cv2 writes with each filter type read back exactly; 16-bit
    samples are big-endian in the file."""
    img = png_image(kind, seed=1)
    for name in CV2_FILTERS:
        path = str(tmp_path / "cv2.png")
        cv2.imwrite(path, to_bgr(img),
                    [cv2.IMWRITE_PNG_FILTER,
                     getattr(cv2, f"IMWRITE_PNG_{name}")])
        got = image_io.read_png(path)
        assert got.dtype == img.dtype, name
        np.testing.assert_array_equal(got, img, err_msg=name)


def test_png_palette_gray_alpha_and_low_depths():
    """Palette, gray + alpha and 1/2/4-bit gray files (written here by
    hand) decode as libpng expands them."""
    import struct
    import zlib

    def png(w, h, depth, ctype, rows, plte=None):
        chunk = (lambda t, b: struct.pack(">I", len(b)) + t + b
                 + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF))
        raw = b"".join(b"\x00" + r for r in rows)
        return (image_io.PNG_MAGIC + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + (chunk(b"PLTE", plte) if plte else b"")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))

    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    idx = rng.integers(0, 4, (3, 5), dtype=np.uint8)
    blob = png(5, 3, 8, 3, [r.tobytes() for r in idx], pal.tobytes())
    np.testing.assert_array_equal(image_io.decode_png(blob), pal[idx])
    np.testing.assert_array_equal(
        image_io.decode_png(blob),
        cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
        [..., ::-1])
    ga = rng.integers(0, 256, (3, 4, 2), dtype=np.uint8)
    blob = png(4, 3, 8, 4, [r.tobytes() for r in ga])
    np.testing.assert_array_equal(image_io.decode_png(blob), ga)
    for depth in (1, 2, 4):
        vals = rng.integers(0, 1 << depth, (3, 7), dtype=np.uint8)
        bits = np.unpackbits(vals[..., None], axis=-1)[..., 8 - depth:]
        rows = [np.packbits(r.reshape(-1)).tobytes() for r in bits]
        got = image_io.decode_png(png(7, 3, depth, 0, rows))
        want = cv2.imdecode(np.frombuffer(png(7, 3, depth, 0, rows),
                                          np.uint8), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(got, want, err_msg=str(depth))


def test_png_refuses_what_it_does_not_read():
    img = png_image("rgb8")
    blob = bytearray(image_io.encode_png(img))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.decode_png(b"\xff\xd8" + bytes(blob[2:]))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        image_io.encode_png(img.astype(np.float32))


# --------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("restart", [0, 3], ids=["plain", "restarts"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_jpeg_decode_matches_cv2(sampling, restart):
    """cv2-written baseline JPEGs (quality 90) decode to cv2.imdecode's
    pixels bit for bit: libjpeg's ISLOW IDCT, fancy upsampling and colour
    tables, through restart markers and byte stuffing."""
    for i, (h, w) in enumerate(JPEG_SIZES):
        ok, buf = cv2.imencode(".jpg", photo(h, w, i)[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, SAMPLINGS[
                sampling]),
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
        assert ok
        want = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(image_io.decode_jpeg(buf.tobytes()),
                                      want, err_msg=str((h, w)))


def test_jpeg_gray_decode_and_encode_match_cv2():
    gray = photo(45, 61)[..., 0]
    ok, buf = cv2.imencode(".jpg", gray)
    np.testing.assert_array_equal(image_io.decode_jpeg(buf.tobytes()),
                                  cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    mine = image_io.encode_jpeg(gray)
    d = (cv2.imdecode(np.frombuffer(mine, np.uint8), cv2.IMREAD_UNCHANGED)
         .astype(int) - cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    assert np.abs(d).max() <= 1


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_jpeg_encode_matches_cv2(sampling):
    """cv2.imdecode of the port's file against cv2.imdecode of cv2's at
    the same quality and sampling: within 1 level (the gate; identical
    bytes are the aim, and the port's tables and headers are libjpeg's)."""
    for i, (h, w) in enumerate(JPEG_SIZES):
        img = photo(h, w, 10 + i)
        ok, buf = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, SAMPLINGS[sampling])])
        mine = image_io.encode_jpeg(img, 95, sampling)
        want = cv2.imdecode(buf, cv2.IMREAD_COLOR).astype(int)
        got = cv2.imdecode(np.frombuffer(mine, np.uint8), cv2.IMREAD_COLOR)
        assert np.abs(got.astype(int) - want).max() <= 1, (h, w)


def test_jpeg_defaults_are_cv2s():
    """write_jpeg's defaults, quality 95 at 4:2:0, give cv2.imwrite's
    default file (SOF0 sampling 0x22/0x11/0x11, the q95 tables)."""
    img = photo(40, 56, 5)
    ok, buf = cv2.imencode(".jpg", img[..., ::-1])
    mine = image_io.encode_jpeg(img)
    sof = mine.index(b"\xff\xc0")
    assert mine[sof + 11:sof + 20:3] == b"\x22\x11\x11"
    head = buf.tobytes()
    assert mine[:mine.index(b"\xff\xda")] == head[:head.index(b"\xff\xda")]


def test_jpeg_refuses_progressive():
    ok, buf = cv2.imencode(".jpg", photo(24, 32)[..., ::-1],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        image_io.decode_jpeg(buf.tobytes())


def test_read_image_dispatches_on_magic(tmp_path):
    img = photo(16, 24)
    image_io.write_png(str(tmp_path / "a.bin"), img)
    image_io.write_jpeg(str(tmp_path / "b.bin"), img)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path /
                                                          "a.bin")), img)
    assert image_io.read_image(str(tmp_path / "b.bin")).shape == img.shape
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image_io.read_image(b"GIF89a....")


# ---------------------------------------------------------------------- AVI
def test_avi_reads_in_cv2(tmp_path):
    """cv2.VideoCapture (its own Motion-JPEG AVI reader, which decodes with
    libjpeg) reads the port's file: the frame count, the frame rate, the
    size and every pixel of libjpeg's decoding of each frame, as
    read_avi_frames gives them."""
    path = str(tmp_path / "v.avi")
    frames = [photo(48, 64, k) for k in range(5)]
    with image_io.AviWriter(path, 10, (64, 48)) as vw:
        for fr in frames:
            vw.write(fr)
    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5
    assert cap.get(cv2.CAP_PROP_FPS) == 10
    got = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        got.append(fr[..., ::-1])
    cap.release()
    ours = image_io.read_avi_frames(path)
    assert len(got) == len(ours) == 5
    for g, o, f in zip(got, ours, frames):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(
            o, image_io.decode_jpeg(image_io.encode_jpeg(f)))


def test_avi_refuses_other_containers(tmp_path):
    with pytest.raises(ValueError, match=r"\.avi"):
        image_io.AviWriter(str(tmp_path / "v.mp4"), 10, (8, 8))
    with image_io.AviWriter(str(tmp_path / "v.avi"), 10, (8, 8)) as vw:
        with pytest.raises(ValueError, match="uint8"):
            vw.write(np.zeros((8, 9, 3), np.uint8))


# -------------------------------------------------------------- rasteriser
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jet_matches_matplotlib(dtype):
    """jet equals matplotlib.cm.jet (RGB) exactly, at 10,001 points of
    [0, 1], at the 256 cell boundaries and beside them, and beyond."""
    cm = pytest.importorskip("matplotlib.cm")
    b = np.arange(257) / 256.0
    xs = np.concatenate([np.linspace(0, 1, 10001), b,
                         np.nextafter(b, -1)[1:], np.nextafter(b, 2)[:-1],
                         [-0.5, 1.5]]).astype(dtype)
    np.testing.assert_array_equal(raster.jet(xs), cm.jet(xs)[..., :3])
    np.testing.assert_array_equal(raster.JET_LUT,
                                  cm.jet(np.arange(256))[:, :3])


@pytest.mark.parametrize("src,dst", [((48, 64), (30, 20)),
                                     ((480, 480), (680, 680)),
                                     ((17, 23), (50, 9)),
                                     ((40, 40), (20, 20)),
                                     ((33, 47), (47, 33))])
def test_resize_bilinear_matches_cv2(src, dst):
    """Within 1 level of cv2.resize(INTER_LINEAR): cv2's SIMD vertical
    pass drops the 4 low bits of the horizontal sums before its rounding,
    the port rounds the exact fixed-point sum once."""
    img = np.random.default_rng(3).integers(0, 256, src + (3,), np.uint8)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    got = raster.resize_bilinear(img, dst)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_lines_and_text():
    img = np.zeros((20, 30, 3), np.uint8)
    raster.draw_line(img, (2, 3), (25, 15), (255, 0, 0))
    ys, xs = np.nonzero(img[..., 0])
    assert (3, 2) in zip(ys, xs) and (15, 25) in zip(ys, xs)
    assert len(xs) == 24                  # one pixel per step of x
    raster.draw_line(img, (-5, 0), (40, 0), (0, 255, 0))   # clipped
    assert img[0, :, 1].all()
    mask = raster.text_mask("Ab", 2)
    assert mask.shape == (14, 24) and mask.any()
    img = np.zeros((30, 60, 3), np.uint8)
    raster.put_text(img, "Hi", (8, 20), (255, 255, 255))
    ys, xs = np.nonzero(img[..., 0])
    assert ys.max() == 20 and ys.min() == 14 and xs.min() == 8


def test_trajectory_panels():
    t = np.cumsum(np.random.default_rng(4).normal(0, 0.05, (50, 3)), 0)
    img = raster.trajectory_panels(t)
    assert img.shape == (600, 1200, 3) and img.dtype == np.uint8
    assert (img == raster.GREEN).all(-1).any()
    assert (img == raster.RED).all(-1).any()
    assert (img == raster.BLUE).all(-1).sum() > 100
