"""A small rasteriser for the port's visual artifacts, in numpy (the port's
replacement for the matplotlib and cv2 drawing calls of the JAX package's
saver and offline tools):

  * ``jet``: matplotlib's ``cm.jet``, exactly: its 256-entry table (the
    segment data evaluated at ``i / 255`` by matplotlib's own formula, in
    float64) indexed by ``min(int(x * 256), 255)``;
  * ``resize_bilinear``: cv2's ``INTER_LINEAR`` (half-pixel centres, 11-bit
    fixed-point weights, rounded once after the vertical pass);
  * ``draw_line``: a one-pixel line through the rounded points of a DDA
    walk (cv2's ``LINE_AA`` blends; this draws plain pixels);
  * ``put_text``: text from a 5x7 bitmap font kept below as a byte table
    (cv2 draws Hershey strokes);
  * ``trajectory_panels``: the trajectory plot of ``offline.py`` (a
    top-down panel and an oblique panel, matplotlib's in the JAX package).

Images are uint8 [H, W, 3]; colours are given in the image's channel order.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# matplotlib's _jet_data: (x, y0, y1) per channel
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
JET_N = 256


def _lookup_table(data, n: int) -> np.ndarray:
    """matplotlib.colors._create_lookup_table (gamma 1), op for op."""
    adata = np.array(data)
    x = adata[:, 0] * (n - 1)
    y0, y1 = adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_lookup_table(_JET_DATA[c], JET_N)
                    for c in ("red", "green", "blue")], axis=-1)


def jet(x) -> np.ndarray:
    """matplotlib.cm.jet(x)[..., :3] for x in [0, 1] (below 0: the first
    entry, above 1: the last; NaN: black), float64 [..., 3]."""
    xa = np.array(x, dtype=np.float64 if np.ndim(x) == 0 else None,
                  copy=True)
    if xa.dtype.kind != "f":
        xa = xa.astype(np.float64)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa), 0, JET_N - 1).astype(np.int64)
    out = JET_LUT[idx]
    out[bad] = 0.0
    return out


# ------------------------------------------------------------------ resize
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(dst: int, src: int):
    """cv2's INTER_LINEAR source index and fixed-point weights per output
    index (each weight rounded on its own, as saturate_cast<short>)."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    low = i0 < 0
    f[low], i0[low] = 0, 0
    high = i0 >= src - 1
    f[high], i0[high] = 0, src - 1
    a0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int64)
    a1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    return i0, np.minimum(i0 + 1, src - 1), a0, a1


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W(, C)] -> [h, w(, C)] for size = (w, h), as
    cv2.resize(img, (w, h)) with INTER_LINEAR computes it: a horizontal
    pass in 11-bit fixed point, a vertical one, then one rounding shift of
    22 bits. (cv2's SIMD vertical pass drops the 4 low bits of the
    horizontal sums first, so its pixels may differ from these by 1.)"""
    w, h = int(size[0]), int(size[1])
    src = np.asarray(img)
    sh, sw = src.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(w, sw)
    y0, y1, ay0, ay1 = _linear_taps(h, sh)
    s = src.astype(np.int64)
    ex = (slice(None), None) if s.ndim == 3 else (slice(None),)
    rows = s[:, x0] * ax0[ex] + s[:, x1] * ax1[ex]
    ey = (slice(None), None, None) if s.ndim == 3 else (slice(None), None)
    val = rows[y0] * ay0[ey] + rows[y1] * ay1[ey]
    out = (val + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------- lines
def line_pixels(p0: Sequence[int], p1: Sequence[int]) -> np.ndarray:
    """The integer pixels [n, 2] (x, y) of a line from p0 to p1, ends
    included: one per step of the longer axis, rounded."""
    (xa, ya), (xb, yb) = (np.asarray(p0, np.int64), np.asarray(p1, np.int64))
    n = int(max(abs(xb - xa), abs(yb - ya)))
    t = np.arange(n + 1) / max(n, 1)
    xs = np.rint(xa + (xb - xa) * t).astype(np.int64)
    ys = np.rint(ya + (yb - ya) * t).astype(np.int64)
    return np.stack([xs, ys], axis=-1)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """Draw a line from p0 to p1 (pixel (x, y)) into img in place; pixels
    outside the image are dropped."""
    h, w = img.shape[:2]
    pts = line_pixels(p0, p1)
    r = thickness // 2
    for dy in range(-r, thickness - r):
        for dx in range(-r, thickness - r):
            x, y = pts[:, 0] + dx, pts[:, 1] + dy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            img[y[ok], x[ok]] = color


def draw_polyline(img: np.ndarray, pts: np.ndarray, color,
                  thickness: int = 1) -> None:
    pts = np.rint(np.asarray(pts, np.float64)).astype(np.int64)
    for a, b in zip(pts[:-1], pts[1:]):
        draw_line(img, a, b, color, thickness)


def fill_disc(img: np.ndarray, center, radius: int, color) -> None:
    h, w = img.shape[:2]
    cx, cy = (int(round(float(c))) for c in center)
    ys, xs = np.mgrid[max(cy - radius, 0):min(cy + radius + 1, h),
                      max(cx - radius, 0):min(cx + radius + 1, w)]
    inside = (xs - cx) ** 2 + (ys - cy) ** 2 <= radius * radius
    img[ys[inside], xs[inside]] = color


# -------------------------------------------------------------------- text
# The classic public-domain 5x7 font, ASCII 32..126: five column bytes per
# glyph, bit 0 the top row.
_FONT_5X7 = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "14083e0814" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090901" "3e4149497a"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f020c027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "3f4038403f" "6314081463" "0708700807" "6151494543" "007f414100"
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "0c5252523e" "7f08040478" "00447d4000" "2040443d00"
    "7f10284400" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "1008081008")
FONT_W, FONT_H, FONT_ADVANCE = 5, 7, 6
_GLYPHS = (np.unpackbits(np.frombuffer(_FONT_5X7, np.uint8).reshape(-1, 5),
                         axis=1, bitorder="little")
           .reshape(-1, 5, 8)[:, :, :FONT_H].transpose(0, 2, 1).astype(bool))


def text_mask(text: str, scale: int = 1) -> np.ndarray:
    """The bool [7 * scale, 6 * scale * len(text)] pixels of `text`
    (characters outside ASCII 32..126 draw as '?')."""
    codes = [c - 32 if 32 <= c <= 126 else ord("?") - 32
             for c in text.encode("ascii", "replace")]
    cells = np.zeros((len(codes), FONT_H, FONT_ADVANCE), bool)
    if codes:
        cells[:, :, :FONT_W] = _GLYPHS[codes]
    mask = cells.transpose(1, 0, 2).reshape(FONT_H, -1)
    return mask.repeat(scale, 0).repeat(scale, 1)


def put_text(img: np.ndarray, text: str, org, color, scale: int = 1) -> None:
    """Draw `text` with its baseline's left end at org = (x, y), as
    cv2.putText places text, into img in place."""
    mask = text_mask(text, scale)
    h, w = img.shape[:2]
    x0, y0 = int(org[0]), int(org[1]) - mask.shape[0] + 1
    ys, xs = np.nonzero(mask)
    ys, xs = ys + y0, xs + x0
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


# ------------------------------------------------------ trajectory panels
BLUE, GREEN, RED = (31, 119, 180), (0, 160, 0), (214, 39, 40)
INK, GRID = (0, 0, 0), (200, 200, 200)


def _fit(pts: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """2-D points -> pixel (x, y) inside box = (x0, y0, x1, y1), one scale
    for both axes (equal aspect), y up."""
    x0, y0, x1, y1 = box
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    s = min((x1 - x0) / span[0], (y1 - y0) / span[1])
    mid = (lo + hi) / 2.0
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    return np.stack([cx + (pts[:, 0] - mid[0]) * s,
                     cy - (pts[:, 1] - mid[1]) * s], axis=-1)


def _frame(img, box, title: str) -> None:
    x0, y0, x1, y1 = box
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                 ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        draw_line(img, a, b, INK)
    tw = text_mask(title, 2).shape[1]
    put_text(img, title, ((x0 + x1 - tw) // 2, y0 - 12), INK, 2)


def oblique_view(t: np.ndarray, azim_deg: float = -60.0,
                 elev_deg: float = 30.0) -> np.ndarray:
    """World points [N, 3] -> [N, 2] seen from matplotlib's default 3-D
    view (azimuth -60, elevation 30 degrees), orthographic, z up."""
    az, el = np.radians(azim_deg), np.radians(elev_deg)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az),
                   np.cos(el)])
    return np.stack([t @ right, t @ up], axis=-1)


def trajectory_panels(t: np.ndarray, size: Tuple[int, int] = (1200, 600)
                      ) -> np.ndarray:
    """The trajectory plot (RGB, size = (w, h)): the positions t [N, 3] in
    a top-down (x, y) panel with the start (green) and end (red) marked,
    and in an oblique panel inside the box of their extents."""
    w, h = size
    img = np.full((h, w, 3), 255, np.uint8)
    t = np.asarray(t, np.float64).reshape(-1, 3)
    m = 60
    left = (m, m + 20, w // 2 - m // 2, h - m)
    right = (w // 2 + m // 2, m + 20, w - m, h - m)
    # top-down
    _frame(img, left, "top-down (x, y)")
    pad = 14
    inner = (left[0] + pad, left[1] + pad, left[2] - pad, left[3] - pad)
    xy = _fit(t[:, :2], inner)
    draw_polyline(img, xy, BLUE, 2)
    fill_disc(img, xy[0], 5, GREEN)
    fill_disc(img, xy[-1], 5, RED)
    lo, hi = t.min(axis=0), t.max(axis=0)
    put_text(img, f"x {lo[0]:.2f} .. {hi[0]:.2f} m   "
             f"y {lo[1]:.2f} .. {hi[1]:.2f} m", (left[0], left[3] + 20),
             INK)
    put_text(img, "start", (left[0] + 4, left[1] + 12), GREEN)
    put_text(img, "end", (left[0] + 40, left[1] + 12), RED)
    # oblique
    _frame(img, right, "3D trajectory")
    corners = np.array([[lo[0] if i & 1 == 0 else hi[0],
                         lo[1] if i & 2 == 0 else hi[1],
                         lo[2] if i & 4 == 0 else hi[2]] for i in range(8)])
    inner = (right[0] + pad, right[1] + pad, right[2] - pad, right[3] - pad)
    proj = _fit(oblique_view(np.concatenate([corners, t])), inner)
    box2d, path2d = proj[:8], proj[8:]
    for i in range(8):
        for bit in (1, 2, 4):
            if not i & bit:
                draw_line(img, np.rint(box2d[i]).astype(int),
                          np.rint(box2d[i | bit]).astype(int), GRID)
    draw_polyline(img, path2d, BLUE, 2)
    put_text(img, f"z {lo[2]:.2f} .. {hi[2]:.2f} m",
             (right[0], right[3] + 20), INK)
    return img


__all__ = ["jet", "JET_LUT", "resize_bilinear", "draw_line", "draw_polyline",
           "line_pixels", "fill_disc", "put_text", "text_mask",
           "oblique_view", "trajectory_panels"]
