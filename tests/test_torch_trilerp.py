"""The uncertainty grid's trilinear sample (naruto_tpu_torch/ops/
grid_sample.py) on the CPU, where its wrappers take their plain versions:
the sample, the grid gradient and the coordinate gradient equal, bit for
bit, those of the dense-pack path it replaced (tests/dense_trilerp.py:
the grid packed into [(X-1)(Y-1)(Z-1), 8] cells, a dense cell sum, the
corner planes added), over samples crowded on few cells or spread thin,
on the clamp fringe and in the grid's last cell, with most cells
untouched; and no tensor sized by the grid's cells is made."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from naruto_tpu_torch.ops import grid_sample
from dense_trilerp import dense_trilerp

torch.set_num_threads(1)

SHAPE = (9, 10, 7)


def _points(kind: str, rng) -> np.ndarray:
    """[N, 3] normalized sample points of each kind."""
    if kind == "sparse":            # 40 samples: most cells untouched
        return rng.uniform(0, 1, (40, 3))
    if kind == "crowded":           # long runs on a few cells
        p = 0.4 + 0.15 * rng.uniform(0, 1, (3000, 3))
        p[:1800] = 0.47 + 0.01 * p[:1800]
        return p
    if kind == "fringe":            # outside [0, 1], and on its faces
        p = rng.uniform(-0.2, 1.2, (500, 3))
        p[:60] = rng.integers(0, 2, (60, 3))
        return p
    if kind == "last_cell":         # the grid's last cell, its far corner
        size = np.asarray(SHAPE, np.float64)
        p = 1.0 - rng.uniform(0, 1, (300, 3)) / size
        p[:10] = 1.0
        return p
    if kind == "one_cell":          # one run of every sample
        return 0.5 + 0.01 * rng.uniform(0, 1, (700, 3))
    raise ValueError(kind)


def _coords(pts: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """Voxel coordinates as trilinear_sample computes them."""
    shape = torch.tensor(SHAPE, dtype=torch.float32)
    g = pts * 2.0 - 1.0
    if align_corners:
        return (g + 1.0) / 2.0 * (shape - 1.0)
    return ((g + 1.0) * shape - 1.0) / 2.0


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "crowded", "fringe",
                                  "last_cell", "one_cell"])
def test_trilerp_equals_the_dense_pack_path(kind, align_corners):
    """The sample, d_vol and d_coords of the grid read directly equal the
    dense-pack path's bit for bit: the same gathers, the same per-cell
    sums over the same rows in the same order, and each vertex's corner
    sums in corner order (an untouched cell's +0 changes no nonzero
    sum)."""
    rng = np.random.default_rng(["sparse", "crowded", "fringe", "last_cell",
                                 "one_cell"].index(kind))
    vol = torch.tensor(rng.normal(size=SHAPE), dtype=torch.float32)
    pts = torch.tensor(_points(kind, rng), dtype=torch.float32)
    coords = _coords(pts, align_corners)
    g = torch.tensor(rng.normal(size=coords.shape[0]), dtype=torch.float32)
    got, want = [], []
    for fn, into in ((grid_sample._trilerp, got), (dense_trilerp, want)):
        v = vol.clone().requires_grad_(True)
        c = coords.clone().requires_grad_(True)
        out = fn(v, c)
        into += [out.detach(), *torch.autograd.grad(out, (v, c), g)]
    for name, a, b in zip(("sample", "d_vol", "d_coords"), got, want):
        assert torch.equal(a, b), name
    if kind == "sparse":
        assert int((got[1] == 0).sum()) > got[1].numel() // 2


def test_trilinear_sample_equals_the_dense_pack_path(monkeypatch):
    """trilinear_sample, the public entry, through both paths: the sample
    and the gradients of the grid and of the normalized points."""
    rng = np.random.default_rng(7)
    vol = torch.tensor(rng.normal(size=SHAPE), dtype=torch.float32)
    pts = torch.tensor(_points("crowded", rng), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=pts.shape[0]), dtype=torch.float32)
    res = []
    for fn in (grid_sample._trilerp, dense_trilerp):
        monkeypatch.setattr(grid_sample, "_trilerp", fn)
        v, p = vol.clone().requires_grad_(True), pts.clone().requires_grad_()
        out = grid_sample.trilinear_sample(v, p)
        res.append([out.detach(), *torch.autograd.grad(out, (v, p), g)])
    for a, b in zip(*res):
        assert torch.equal(a, b)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_no_tensor_sized_by_the_cells():
    """The sample and its gradients make nothing of the grid's
    (X-1)(Y-1)(Z-1) cells: nothing larger than the grid itself, no
    [cells, 8] pack, no dense cell sum."""
    X, Y, Z = 40, 41, 42
    rng = np.random.default_rng(3)
    vol = torch.tensor(rng.normal(size=(X, Y, Z)), dtype=torch.float32,
                       requires_grad=True)
    pts = torch.tensor(rng.uniform(0, 1, (500, 3)), dtype=torch.float32,
                       requires_grad=True)
    with _Shapes() as seen:
        out = grid_sample.trilinear_sample(vol, pts)
        torch.autograd.grad(out.square().sum(), (vol, pts))
    cells = (X - 1) * (Y - 1) * (Z - 1)
    sizes = [int(np.prod(s)) for s in seen.shapes]
    assert max(sizes) == X * Y * Z
    assert not [s for s in seen.shapes if cells in s or
                int(np.prod(s)) == 8 * cells]


def test_trilerp_wrappers_refuse():
    """The wrappers take float32 grids and coordinates, int32 keys and
    ranks, contiguous and of the shapes they name, on either device."""
    vol = torch.zeros(SHAPE)
    coords = torch.zeros((16, 3))
    with pytest.raises(TypeError):
        grid_sample.trilerp_forward(vol.double(), coords)
    with pytest.raises(TypeError):
        grid_sample.trilerp_forward(vol, coords.half())
    with pytest.raises(ValueError, match="contiguous"):
        grid_sample.trilerp_forward(vol, torch.zeros((3, 16)).t())
    with pytest.raises(ValueError):
        grid_sample.trilerp_forward(vol, torch.zeros((16, 2)))
    with pytest.raises(ValueError):
        grid_sample.trilerp_forward(torch.zeros((1, 4, 4)), coords)
    si = torch.zeros(16, dtype=torch.int32)
    d_cell = torch.zeros((16, 8))
    with pytest.raises(TypeError):
        grid_sample.trilerp_vjp(SHAPE, si.long(), si, d_cell)
    with pytest.raises(ValueError, match="contiguous"):
        grid_sample.trilerp_vjp(SHAPE, si, si, torch.zeros((8, 16)).t())
    with pytest.raises(ValueError):
        grid_sample.trilerp_vjp(SHAPE, si, si[:8], d_cell)
