"""The port's mesh modules (isosurfacing, PLY IO, extraction from the field)
and its checkpoints against naruto_tpu on the same inputs and weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.mapping import field as jfield
from naruto_tpu.mapping.mapper import Mapper as JMapper
from naruto_tpu.mesh import extract as jextract
from naruto_tpu.mesh import marching as jmarching
from naruto_tpu.mesh import ply as jply
from naruto_tpu.evaluation import eval_mad as jeval_mad
from naruto_tpu.evaluation import eval_mesh as jeval_mesh
from naruto_tpu_torch.config import make_config as tmake_config
from naruto_tpu_torch.evaluation import eval_mad as teval_mad
from naruto_tpu_torch.evaluation import eval_mesh as teval_mesh
from naruto_tpu_torch.mapping import field as tfield
from naruto_tpu_torch.mapping.field import query_sdf
from naruto_tpu_torch.mapping.mapper import Mapper as TMapper
from naruto_tpu_torch.mapping.mapper import field_spec_from_config
from naruto_tpu_torch.mesh import extract as textract
from naruto_tpu_torch.mesh import marching as tmarching
from naruto_tpu_torch.mesh import ply as tply
from naruto_tpu_torch.native import build as tbuild
from naruto_tpu_torch.utils import ckpt_io

torch.set_num_threads(1)

BOUND = ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0))
TINY = {"cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "iters": 2, "first_iters": 2,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "bound": BOUND, "marching_cubes_bound": BOUND,
                   "voxel_size": 0.5},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4}}
SPHERE_C, SPHERE_R = np.array([0.1, -0.05, 0.0], np.float32), 0.55
VOXEL = 0.05
# the dense SDF (|sdf| up to ~5) of the two packages differs by f32 sums in
# another order: measured 9.5e-7
DENSE_ATOL = 5e-6
VERT_ATOL_M = 1e-5          # 1e-3 cm
ROW_ATOL_CM = 1e-3


def sphere_sdf(n=24, r=8.0):
    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2.0
    return np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - r


def _to_jax_params(params_t, template):
    """The port's params as the JAX package's params pytree."""
    leaves = [ckpt_io._to_numpy(v) for _, v in
              ckpt_io.flatten_with_keys(params_t)]
    jl, treedef = jax.tree_util.tree_flatten(template)
    assert [np.shape(a) for a in jl] == [a.shape for a in leaves]
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a, j.dtype) for a, j in zip(leaves, jl)])


@pytest.fixture(scope="module")
def fitted_pair():
    """A tiny JAX Mapper whose field was fitted to a sphere's SDF (so the
    isosurface is well conditioned), and a port Mapper that loaded its
    weights."""
    cfg_t = tmake_config("Replica", "office0", num_iter=10, overrides=TINY)
    fit = TMapper(cfg_t, device="cpu")
    opt = torch.optim.Adam(fit._all_params(), lr=1e-2)
    g = torch.Generator().manual_seed(0)
    c = torch.from_numpy(SPHERE_C)
    for _ in range(80):
        x01 = torch.rand((2048, 3), generator=g)
        target = (torch.linalg.norm(x01 * 2 - 1 - c, dim=-1) - SPHERE_R) * 4
        sdf, _ = query_sdf(fit.params, x01, fit.spec, with_uncert=True)
        loss = ((sdf - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():           # an uncertainty that varies in space
        grid = fit.params["uncert_grid"]
        grid += torch.from_numpy(np.random.default_rng(1).normal(
            size=tuple(grid.shape)).astype(np.float32))

    mj = JMapper(jmake_config("Replica", "office0", num_iter=10,
                              overrides=TINY))
    mj.state = mj.state._replace(
        params=_to_jax_params(fit.params, mj.state.params))
    mt = TMapper(cfg_t, device="cpu")
    mt.load_weights(jax.tree_util.tree_map(np.asarray, mj.state.params))
    return mj, mt


@pytest.fixture(scope="module")
def gt_sphere():
    """The fitted sphere as a GT mesh (metric coordinates)."""
    n, vs = 41, VOXEL
    g = np.arange(n, dtype=np.float32) * vs - 1.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt((x - SPHERE_C[0]) ** 2 + (y - SPHERE_C[1]) ** 2
                  + (z - SPHERE_C[2]) ** 2) - SPHERE_R
    v, f = tmarching.marching_cubes(sdf, truncation=1e9)
    return (v * vs - 1.0).astype(np.float32), f


# ------------------------------------------------------------ marching tets
@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("truncation", [1e9, 2.0])
def test_marching_cubes_matches_jax(backend, truncation):
    """Both backends give the JAX package's vertices and faces bit for bit
    (the same C++ source under the same flags; the same numpy code)."""
    sdf = sphere_sdf()
    sdf[3:6, 3:6, 3:6] = -1.0            # a second, small component
    vt, ft = tmarching.marching_cubes(sdf, truncation=truncation,
                                      backend=backend)
    vj, fj = jmarching.marching_cubes(sdf, truncation=truncation,
                                      backend=backend)
    assert len(ft) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert vt.dtype == np.float32 and ft.dtype == np.int32


def test_marching_cubes_raises_when_the_build_fails(monkeypatch):
    """The default backend never falls back to numpy quietly: a g++ failure
    raises."""
    tmarching._load_lib.cache_clear()
    monkeypatch.setattr(tbuild, "CXXFLAGS",
                        [*tbuild.CXXFLAGS, "-fno-such-flag-exists"])
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tmarching.marching_cubes(sphere_sdf(8, 2.0))
    finally:
        tmarching._load_lib.cache_clear()
    with pytest.raises(ValueError, match="unknown marching backend"):
        tmarching.marching_cubes(sphere_sdf(8, 2.0), backend="cuda")


# ---------------------------------------------------------------------- ply
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_crosses_packages(tmp_path, binary, writer):
    """A PLY either package writes reads back equal in the other."""
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(10, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [7, 8, 9]], dtype=np.int32)
    colors = rng.uniform(size=(10, 3)).astype(np.float32)
    w, r = (tply, jply) if writer == "port" else (jply, tply)
    p = str(tmp_path / "m.ply")
    w.write_ply(p, verts, faces, colors, binary=binary)
    got, want = r.read_ply(p), w.read_ply(p)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], verts, rtol=1e-6)
    np.testing.assert_array_equal(got[1], faces)


# --------------------------------------------------------------- extraction
def test_dense_sdf_matches_jax(fitted_pair):
    mj, mt = fitted_pair
    bound = np.asarray(BOUND, np.float32)
    sj, uj, axes_j = jextract._dense_sdf(mj, bound, VOXEL)
    st, ut, axes_t = textract._dense_sdf(mt, bound, VOXEL)
    for a, b in zip(axes_t, axes_j):
        np.testing.assert_array_equal(a, b)
    assert st.shape == sj.shape == (41, 41, 41)
    assert np.abs(st - sj).max() < DENSE_ATOL
    assert np.abs(ut - uj).max() < DENSE_ATOL
    # chunking changes nothing: 41^3 points in chunks of 1000
    st2, ut2, _ = textract._dense_sdf(mt, bound, VOXEL, chunk=1000)
    np.testing.assert_array_equal(st2, st)
    np.testing.assert_array_equal(ut2, ut)


def test_extract_mesh_matches_jax(fitted_pair, gt_sphere):
    """The same mesh, its colours, and the same metric row against the
    sphere."""
    mj, mt = fitted_pair
    vj, fj, cj = jextract.extract_mesh(mj, VOXEL)
    vt, ft, ct = textract.extract_mesh(mt, VOXEL)
    assert len(ft) > 1000
    np.testing.assert_array_equal(ft, fj)
    assert np.abs(vt - vj).max() < VERT_ATOL_M
    assert np.abs(ct - cj).max() < 1e-5
    r = np.linalg.norm(vt - SPHERE_C, axis=1)
    assert np.abs(r - SPHERE_R).max() < 0.05     # the field learned it

    gv, gf = gt_sphere
    row_t = teval_mesh(vt, ft, gv, gf, n_samples=20_000)
    row_j = jeval_mesh(vj, fj, gv, gf, n_samples=20_000)
    assert row_t.keys() == row_j.keys()
    for k in row_t:
        assert abs(row_t[k] - row_j[k]) < ROW_ATOL_CM, k


def test_extract_mesh_uncert_colours(fitted_pair):
    """The uncertainty mesh's jet colouring: the JAX package's through
    matplotlib, the port's through its own table (visualization/raster.py),
    which needs no matplotlib."""
    mj, mt = fitted_pair
    vj, fj, cj = jextract.extract_mesh(mj, 0.1, color_mode="uncert")
    vt, ft, ct = textract.extract_mesh(mt, 0.1, color_mode="uncert")
    np.testing.assert_array_equal(ft, fj)
    assert np.abs(ct - cj).max() < 1e-4


def test_eval_mad_matches_jax(fitted_pair, gt_sphere):
    mj, mt = fitted_pair
    gv, gf = gt_sphere
    got = teval_mad(mt, gv, gf, n_samples=20_000)
    want = jeval_mad(mj, gv, gf, n_samples=20_000)
    assert got < 5.0                              # cm: the field fits
    assert abs(got - want) < ROW_ATOL_CM


def test_save_mesh_paths(fitted_pair, tmp_path):
    """Mapper.save_mesh writes under result_dir/mesh, as the JAX mapper's;
    without a result_dir it writes nothing."""
    _, mt = fitted_pair
    mt.result_dir = None
    assert mt.save_mesh(3, voxel_size=0.1) is None
    mt.result_dir = str(tmp_path)
    try:
        path = mt.save_mesh(3, voxel_size=0.1)
    finally:
        mt.result_dir = None
    assert path == str(tmp_path / "mesh" / "mesh_0003.ply")
    v, f, c = jply.read_ply(path)
    assert len(f) > 100 and c is not None


# -------------------------------------------------------------- checkpoints
def _sdf_points():
    return np.random.default_rng(5).uniform(-1, 1, (500, 3)).astype(
        np.float32)


def test_port_checkpoint_loads_in_jax(fitted_pair, tmp_path):
    """A checkpoint the port writes loads in the unchanged JAX Mapper's
    load_ckpt: the same field, poses and step."""
    mj, mt = fitted_pair
    mt.poses[3] = torch.from_numpy(np.diag([1.0, -1.0, -1.0, 1.0]).astype(
        np.float32))
    mt.step = 3
    path = str(tmp_path / "port.pkl")
    mt.save_ckpt(path)
    fresh = JMapper(mj.cfg)
    fresh.load_ckpt(path)
    assert fresh.step == 3
    np.testing.assert_array_equal(np.asarray(fresh.state.poses),
                                  mt.poses.numpy())
    np.testing.assert_array_equal(fresh.predict_sdf(_sdf_points()),
                                  mj.predict_sdf(_sdf_points()))


def test_jax_checkpoint_loads_in_port(fitted_pair, tmp_path):
    mj, mt = fitted_pair
    mj.step = 7
    path = str(tmp_path / "jax.pkl")
    mj.save_ckpt(path)
    fresh = TMapper(mt.cfg, device="cpu")
    fresh.load_ckpt(path)
    assert fresh.step == 7
    np.testing.assert_array_equal(fresh.poses.numpy(),
                                  np.asarray(mj.state.poses))
    np.testing.assert_array_equal(fresh.predict_sdf(_sdf_points()),
                                  mt.predict_sdf(_sdf_points()))


def test_checkpoint_of_another_layout_is_refused(fitted_pair, tmp_path):
    mj, _ = fitted_pair
    path = str(tmp_path / "jax.pkl")
    mj.save_ckpt(path)
    other = tmake_config("Replica", "office0", num_iter=10, overrides={
        **TINY, "grid": {**TINY["grid"], "n_levels": 3}})
    with pytest.raises(ValueError, match="incompatible"):
        TMapper(other, device="cpu").load_ckpt(path)


def _jax_spec(cfg_t):
    return jfield.FieldSpec(**dataclasses.asdict(field_spec_from_config(
        cfg_t)))


@pytest.mark.parametrize("overrides", [None, TINY], ids=["office0", "24x32"])
def test_treedef_string_matches_jax(overrides):
    """The structure string the port writes equals
    str(jax.tree_util.tree_structure(...)) of the JAX Mapper's tree."""
    cfg_t = tmake_config("Replica", "office0", overrides=overrides)
    spec_t = field_spec_from_config(cfg_t)
    params_t = tfield.init_field_params(spec_t, torch.Generator(), "cpu")
    params_j = jax.eval_shape(lambda: jfield.init_field_params(
        jax.random.PRNGKey(0), _jax_spec(cfg_t)))
    poses = np.zeros((3, 4, 4), np.float32)
    want = str(jax.tree_util.tree_structure(
        {"params": params_j, "poses": poses}))
    assert ckpt_io.treedef_fingerprint(
        {"params": params_t, "poses": poses}) == want
    keys_j = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  {"params": params_j, "poses": poses})[0]]
    assert [k for k, _ in ckpt_io.flatten_with_keys(
        {"params": params_t, "poses": poses})] == keys_j


def test_treedef_string_of_nested_containers():
    tree = {"b": [np.zeros(1), (np.zeros(1),)], "a": {"z": np.zeros(1),
                                                       "y": ()}}
    assert ckpt_io.treedef_fingerprint(tree) == str(
        jax.tree_util.tree_structure(tree))
