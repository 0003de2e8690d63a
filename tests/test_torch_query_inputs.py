"""The vertex grid's SDF decoder input (naruto_tpu_torch/ops/encoding.py
``vertex_query_inputs``, ``csrc/query_inputs.cu`` on a card) on the CPU:
its plain version is the encode and the one-blob concatenated, the
kernel's cell, weight and row arithmetic (emulated in numpy float32 in the
kernel's order) equals the chain's, what the wrapper refuses, and the
field's dispatch, which takes the chain on the CPU, with a gradient asked,
and on the other layouts and gather types. The kernel itself runs in
tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.mapping import field
from naruto_tpu_torch.mapping.mapper import field_spec_from_config
from naruto_tpu_torch.ops import encoding
from naruto_tpu_torch.ops.one_blob import one_blob_encode

torch.set_num_threads(1)

PARITY_GRID = {"layout": "vertex", "n_levels": 16, "n_features_per_level": 2,
               "table_dtype": "float32"}
SCENES = {"jiraiya": ("NARUTO", "jiraiya"), "office0": ("Replica", "office0")}


def _spec(scene: str, grid=PARITY_GRID) -> field.FieldSpec:
    return field_spec_from_config(make_config(*SCENES[scene],
                                              overrides={"grid": grid}))


def _points(n: int = 4913, seed: int = 0) -> torch.Tensor:
    """n points in [0, 1]^3: a tenth with a coordinate on a face (0 or 1),
    where the cell clamps act, and the eight corners of the bound."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, generator=g)
    k = n // 10
    x[torch.arange(k), torch.randint(0, 3, (k,), generator=g)] = \
        torch.randint(0, 2, (k,), generator=g).float()
    x[k:k + 8] = torch.tensor(encoding._CORNERS, dtype=torch.float32)
    return x


def _table(spec: encoding.HashGridSpec, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(spec.total_entries, spec.n_features, generator=g)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_version_is_the_encode_and_the_one_blob(scene):
    """On the CPU the wrapper gives [N, L*F + 3*bins] f32, row-major: the
    hash features, then the one-blob, each bit for bit its own chain, at
    the scene's vertex spec."""
    spec = _spec(scene)
    hs = spec.hash_spec
    x, table = _points(), _table(hs)
    with torch.no_grad():
        got = encoding.vertex_query_inputs(table, x, hs, spec.pos_n_bins)
        h = encoding.hash_encode(table, x, hs)
        p = one_blob_encode(x, spec.pos_n_bins)
    assert got.shape == (x.shape[0], 80) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert torch.equal(got[:, :hs.output_dim], h)
    assert torch.equal(got[:, hs.output_dim:], p)
    assert torch.equal(got, torch.cat([h, p], dim=-1))


def _kernel_cells(x: np.ndarray, res: int):
    """The kernel's cell(): (i0, f) in numpy float32, its order."""
    pos = x * np.float32(res)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, res - 1)
    f = np.minimum(np.maximum(pos - i0.astype(np.float32), np.float32(0)),
                   np.float32(1))
    return i0, f


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_arithmetic_is_the_chain(scene):
    """csrc/query_inputs.cu's cell bases, fractions, corner rows (a dense
    level's cx + (cy + cz*s)*s, a hashed level's hash in 32 bits) and
    weights ((t_x * t_y) * t_z), emulated in numpy float32 and uint32 in
    its order, equal _corner_indices' rows and weights bit for bit: the
    sum of the 8 corners and erf are the card's, held there."""
    hs = _spec(scene).hash_spec
    x = _points()
    idx, w = encoding._corner_indices(x, hs)
    idx = idx.numpy().reshape(x.shape[0], hs.n_levels, 8)
    xn = x.numpy()
    for lv, (res, dense, off) in enumerate(zip(
            hs.resolutions, hs.dense_mask, hs.level_offsets)):
        i0, f = _kernel_cells(xn, res)
        g = np.float32(1) - f
        for c, (ox, oy, oz) in enumerate(encoding._CORNERS):
            cx, cy, cz = (i0[:, a].astype(np.uint32) + np.uint32(o)
                          for a, o in enumerate((ox, oy, oz)))
            if dense:
                s = np.uint32(res + 1)
                row = cx + (cy + cz * s) * s
            else:
                row = (cx ^ (cy * np.uint32(2654435761))
                       ^ (cz * np.uint32(805459861))) \
                    & np.uint32(hs.table_size - 1)
            np.testing.assert_array_equal(row + np.uint32(off),
                                          idx[:, lv, c].astype(np.uint32))
            t = [f[:, a] if o else g[:, a] for a, o in enumerate((ox, oy,
                                                                  oz))]
            np.testing.assert_array_equal((t[0] * t[1]) * t[2],
                                          w[:, lv, c].numpy())


def test_refusal_names_what_the_kernel_does_not_take():
    """'' for the vertex layout with float32 gathers and no gradient (also
    where the table asks one but autograd is off); a reason for a gradient
    through the table or the points, the hybrid and cell layouts, bfloat16
    gathers, 1 or 8 features a level, an odd level count or a bin count of
    no whole 16-byte store, and float64 points."""
    hs = _spec("office0").hash_spec
    x, table = _points(50), _table(hs)
    assert encoding.query_inputs_refusal(table, x, hs, 16) == ""
    grad_table = table.clone().requires_grad_(True)
    grad_x = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert encoding.query_inputs_refusal(grad_table, grad_x, hs, 16) == ""
    assert encoding.query_inputs_refusal(grad_table, x, hs, 16)
    assert encoding.query_inputs_refusal(table, grad_x, hs, 16)
    for change in ({"layout": "hybrid"}, {"layout": "cell"},
                   {"gather_dtype": "bfloat16"},
                   {"n_features": 1, "n_levels": 16},
                   {"n_features": 8, "n_levels": 4},
                   {"n_features": 2, "n_levels": 3}):
        assert encoding.query_inputs_refusal(
            table, x, dataclasses.replace(hs, **change), 16), change
    assert encoding.query_inputs_refusal(table, x, hs, 6)
    assert encoding.query_inputs_refusal(table, x.double(), hs, 16)


CASES = {
    "vertex": (PARITY_GRID, None),
    "vertex_table_grad": (PARITY_GRID, "table"),
    "vertex_points_grad": (PARITY_GRID, "points"),
    "hybrid": ({"layout": "hybrid", "n_levels": 4, "n_features_per_level": 8,
                "table_dtype": "bfloat16"}, None),
    "cell": ({"layout": "cell", "n_levels": 4, "n_features_per_level": 8,
              "table_dtype": "float32"}, None),
    "vertex_bfloat16": ({**PARITY_GRID, "table_dtype": "bfloat16"}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_takes_the_chain(case, monkeypatch):
    """A stub in the kernel wrapper's place counts no call on the CPU,
    with a gradient asked through the table or the points, and on the
    hybrid, cell and bfloat16 grids: query_sdf, field_query and the
    chunked map query each take the encode and the one-blob, and give the
    same as before the dispatch existed (query_sdf's SDF is the decoder's
    first output on the chain's input)."""
    grid, grad = CASES[case]
    spec = dataclasses.replace(_spec("office0", {**grid, "hash_size": 12}),
                               diff_positions=grad == "points")
    params = field.init_field_params(spec, torch.Generator().manual_seed(2))
    calls = []
    monkeypatch.setattr(field, "vertex_query_inputs",
                        lambda *a: calls.append(a))
    x = _points(700)
    if grad == "table":
        for leaf in encoding.table_leaves(params["table"]):
            leaf.requires_grad_(True)
    elif grad == "points":
        x.requires_grad_(True)
    sdf = field.query_sdf(params, x, spec)
    raw = field.field_query(params, x, spec)
    with torch.no_grad():
        vols = field.chunked_volume_maps(params, x.detach(), spec)
    assert calls == []
    h = encoding.hash_encode(params["table"], x, spec.hash_spec)
    out = field.mlp_apply(params["sdf_mlp"], torch.cat(
        [h, one_blob_encode(x, spec.pos_n_bins)], dim=-1))
    assert torch.equal(sdf, out[:, 0])
    assert torch.equal(raw[:, 3], out[:, 0])
    assert torch.equal(vols[0], out[:, 0].detach())
    assert sdf.requires_grad == (grad is not None)
