"""The vertex layout (configs/parity.yaml: tcnn's vertex-keyed hash grid,
f32 table), the weights carry of the cell-row backward and the position
gradients of the hash encode, against naruto_tpu on the CPU on identical
numpy-seeded inputs; a vertex checkpoint read by both packages; and
configs/parity.yaml through a 40-step passive run of the port's engine."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from naruto_tpu.mapping import mapper as jmapper
from naruto_tpu.ops import encoding as jenc
from naruto_tpu.ops import segment as jseg
from naruto_tpu_torch.config import load_config, make_config
from naruto_tpu_torch.mapping.mapper import Mapper, field_spec_from_config
from naruto_tpu_torch.ops import encoding as tenc
from naruto_tpu_torch.ops import primitives, segment
from naruto_tpu_torch.system import engine as tengine
from naruto_tpu_torch.system.engine import Engine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_CFG = os.path.join(ROOT, "configs", "parity.yaml")
with open(PARITY_CFG) as _f:
    PARITY_GRID = yaml.safe_load(_f)["grid"]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _flat(table):
    return ([table["hash"], *table["dense"]] if isinstance(table, dict)
            else [table])


def _spec_kw(layout, **kw):
    # 3 levels at resolutions 4, 8, 16: dense and hashed levels in each
    # layout (vertex: (R+1)^3 <= 1024 keeps the two coarse ones dense)
    return dict(n_levels=3, log2_table_size=10, base_resolution=4,
                finest_resolution=16, layout=layout, **kw)


def _table(spec_j, scale=1e3):
    table = jenc.init_hash_table(jax.random.PRNGKey(0), spec_j)
    return jax.tree_util.tree_map(lambda a: a * scale, table)


# ------------------------------------------------------------- the layout
def test_vertex_spec_matches_jax():
    """Level sizes, offsets and dense levels of the vertex layout, at the
    parity grid's office0 size too (814,897 table rows)."""
    for kw in (_spec_kw("vertex"),
               dict(n_levels=16, n_features=2, log2_table_size=16,
                    base_resolution=16, finest_resolution=275,
                    layout="vertex")):
        sj, st = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
        assert st.level_offsets == sj.level_offsets
        assert st.dense_mask == sj.dense_mask
        assert st.row_features == sj.row_features == kw.get("n_features", 2)
    cfg = make_config("Replica", "office0", overrides={"grid": PARITY_GRID})
    spec = field_spec_from_config(cfg).hash_spec
    assert (spec.layout, spec.total_entries, spec.resolutions[-1]) == \
        ("vertex", 814_897, 275)
    assert spec.dense_mask[:5] == (True,) * 5 and not any(spec.dense_mask[5:])


def test_corner_indices_match_jax(rng):
    """The 8 corner rows of every (point, level), dense and hashed levels,
    and hashed coordinates whose products overflow 32 bits; int32, as the
    JAX function gives them."""
    kw = dict(n_levels=4, log2_table_size=8, base_resolution=4,
              finest_resolution=600, layout="vertex")
    spec_j, spec_t = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    assert any(spec_t.dense_mask) and not all(spec_t.dense_mask)
    x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 1.0, 0.0], [1e-7, 0.999999, 0.5]]
    j_idx, j_w = jenc._corner_indices(jnp.asarray(x), spec_j)
    t_idx, t_w = tenc._corner_indices(_t(x), spec_t)
    assert t_idx.dtype == torch.int32 and np.asarray(j_idx).dtype == np.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    # jnp.prod and the port's fixed product order: f32 products of 3
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-7)


@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
def test_vertex_encode_and_table_vjp(rng, gather_dtype):
    """Forward: one gather of [N*L*8, F] rows blended in f32 (rel 1e-5).
    Table VJP: bf16-rounded updates g*w summed per vertex, against the
    eager JAX backward (its prefix-sum differences over the sorted
    updates): 1e-5 of max|ref|."""
    kw = _spec_kw("vertex", gather_dtype=gather_dtype)
    spec_j, spec_t = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    table = _table(spec_j)
    x = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    g = rng.normal(size=(400, spec_j.output_dim)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda t: jenc.hash_encode(t, jnp.asarray(x),
                                                    spec_j), table)
    (j_grad,) = vjp(jnp.asarray(g))
    t_table = _t(table, True)
    out = tenc.hash_encode(t_table, _t(x), spec_t)
    (grad,) = torch.autograd.grad(out, [t_table], _t(g))
    assert _rel_err(out.detach().numpy(), j_out) < 1e-5
    assert grad.shape == j_grad.shape
    assert _rel_err(grad.numpy(), j_grad) < 1e-5


def test_vertex_backward_runs_the_kernel_wrappers(rng):
    """The vertex backward is a sort and one sorted_segment_sum of
    bf16-rounded rows (the P1 form) fed the sort permutation: no
    gather_rows of the payload, and no fused scan."""
    spec = tenc.HashGridSpec(**_spec_kw("vertex"))
    table = _t(_table(jenc.HashGridSpec(**_spec_kw("vertex"))), True)
    x = _t(rng.uniform(0, 1, (50, 3)).astype(np.float32))
    out = tenc.hash_encode(table, x, spec)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("gather_rows", "sorted_segment_sum"):
            mp.setattr(primitives, name, functools.partial(
                lambda f, n, *a, **k: (calls.append((n, k)), f(*a, **k))[1],
                getattr(primitives, name), name))
        torch.autograd.grad(out.sum(), [table])
    assert [(n, sorted(k)) for n, k in calls] == \
        [("sorted_segment_sum", ["perm", "round_bf16"])]
    kw = calls[0][1]
    assert kw["round_bf16"] is True
    assert kw["perm"].dtype == torch.int64
    assert kw["perm"].shape == (50 * spec.n_levels * 8,)


@pytest.mark.parametrize("layout", ["vertex", "cell", "hybrid"])
def test_position_grads_match_jax(rng, layout):
    """d_x through the product rule on the f32 features (the derived rows
    in the hybrid layout), against jax.vjp with respect to x: rel 1e-5."""
    kw = _spec_kw(layout, gather_dtype="bfloat16", n_features=4)
    spec_j, spec_t = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    table = _table(spec_j)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, spec_j.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jenc.hash_encode(table, xx, spec_j),
                     jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(g))
    xt = _t(x, True)
    t_table = jax.tree_util.tree_map(lambda a: _t(a), table)
    out = tenc.hash_encode(t_table, xt, spec_t)
    (dx,) = torch.autograd.grad(out, [xt], _t(g))
    assert _rel_err(dx.numpy(), j_dx) < 1e-5


@pytest.mark.parametrize("layout", ["vertex", "hybrid"])
def test_frozen_table_computes_no_table_gradient(rng, layout):
    """Tracking freezes the field: with no table leaf needing a gradient
    the backward launches no segment sum and no scan, only d_x's gather."""
    kw = _spec_kw(layout)
    spec = tenc.HashGridSpec(**kw)
    table = jax.tree_util.tree_map(_t, _table(jenc.HashGridSpec(**kw)))
    xt = _t(rng.uniform(0, 1, (60, 3)).astype(np.float32), True)
    out = tenc.hash_encode(table, xt, spec)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((primitives, "gather_rows"),
                          (primitives, "sorted_segment_sum"),
                          (segment.kernels, "outer_cumsum_slots")):
            mp.setattr(mod, name, functools.partial(
                lambda f, n, *a, **k: (calls.append(n), f(*a, **k))[1],
                getattr(mod, name), name))
        (dx,) = torch.autograd.grad(out.sum(), [xt])
    assert calls == ["gather_rows"] and torch.isfinite(dx).all()


# ------------------------------------------------------ the weights carry
def _outer_inputs(rng, n, L, per, kb):
    # level-range contract: column lv's ids in [lv*per, (lv+1)*per)
    idx = (rng.integers(0, per, (n, L))
           + np.arange(L)[None, :] * per).astype(np.int32)
    w = rng.uniform(0, 1, (n, L, 8)).astype(np.float32)
    b = rng.normal(size=(n, L * kb)).astype(np.float32)
    return idx, w, b, L * per


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n,L,per,kb", [(333, 4, 16, 4), (700, 4, 300, 8),
                                        (1024, 2, 40, 2)])
def test_weights_carry_matches_jax(rng, use_pallas, n, L, per, kb):
    """dense_segment_sum_outer_level_major (bf16 weights and cotangents
    carried through the sort, the fused scan's slot rows) against JAX's
    Pallas branch (interpret) and XLA branch; the pre-sort INT32_MAX
    padding runs where n*L is not a multiple of 512. Slot sums are
    differences of running sums: 2e-6 of max|cumsum|."""
    idx, w, b, size = _outer_inputs(rng, n, L, per, kb)
    ref = np.asarray(jseg.dense_segment_sum_outer_level_major(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(b), size,
        use_pallas=use_pallas))
    got = segment.dense_segment_sum_outer_level_major(
        _t(idx), _t(w), _t(b), size).numpy()
    assert got.shape == (size, 8 * kb)
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("layout", ["cell", "hybrid"])
def test_weights_carry_encode_vjp_matches_jax(rng, layout):
    """sort_carry: weights through hash_encode's table VJP, against the
    eager JAX backward: 1e-5 of max|ref|."""
    kw = _spec_kw(layout, sort_carry="weights")
    spec_j, spec_t = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    table = _table(spec_j)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, spec_j.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jenc.hash_encode(t, jnp.asarray(x), spec_j),
                     table)
    (j_grad,) = vjp(jnp.asarray(g))
    t_table = jax.tree_util.tree_map(lambda a: _t(a, True), table)
    leaves = tenc.table_leaves(t_table)
    out = tenc.hash_encode(t_table, _t(x), spec_t)
    for got, ref in zip(torch.autograd.grad(out, leaves, _t(g)),
                        _flat(j_grad)):
        assert _rel_err(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("pack_bf16", [True, False])
def test_dense_segment_sum_matches_jax(rng, pack_bf16):
    """The vertex backward's segment sum, both forms, at F = 2: the
    bf16-rounded one (pack_bf16, the JAX default) and the exact one."""
    idx = rng.integers(0, 300, 5000).astype(np.int32)
    vals = rng.normal(size=(5000, 2)).astype(np.float32)
    ref = np.asarray(jseg.dense_segment_sum(
        jnp.asarray(idx), jnp.asarray(vals), 300, pack_bf16=pack_bf16))
    got = segment.dense_segment_sum(_t(idx), _t(vals), 300,
                                    pack_bf16=pack_bf16).numpy()
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)


# ----------------------------------------------- configs/parity.yaml, end to end
PARITY_40 = {
    "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
            "cy": 11.5, "far": 3.0},
    "sim": {"pinhole_hw": (24, 32), "erp_hw": (16, 32),
            "scene_path": os.path.join(ROOT, "data", "traj_ab")},
    "grid": {**PARITY_GRID, "hash_size": 12},
    "mapper": {"sample": 64, "iters": 2, "first_iters": 8,
               "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16},
    "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8},
    "mesh": {"voxel_final": 0.1, "voxel_eval": 0.1},
}
# Floors calibrated once against the JAX engine on the same config, seed 0
# and 20,000 eval samples (run outside tier-1): acc 12.94 cm, comp 27.58
# cm, ratio 15.79%, MAD 2.78 cm. They sit ~25-40% beyond those values, as
# tests/test_torch_engine.py's do: the two packages draw from other
# generators, so the rows differ, but a broken layout or backward halves
# the ratio or multiplies the MAD.
FLOORS = {"completion_ratio_pct": 10.0, "mad_cm": 3.9,
          "completion_cm": 38.0, "accuracy_cm": 18.0}


def test_parity_yaml_loads_into_mapper_and_engine(tmp_path):
    cfg = load_config(PARITY_CFG)
    assert cfg.grid.layout == "vertex"
    mapper = Mapper(cfg, device="cpu")
    table = mapper.params["table"]
    assert isinstance(table, torch.Tensor) and table.dtype == torch.float32
    assert tuple(table.shape) == (mapper.spec.hash_spec.total_entries, 2)
    assert mapper.embed_opt.mu[0].shape == table.shape
    small = load_config(PARITY_CFG).replace(enable_active_planning=False)
    from naruto_tpu_torch.config.schema import deep_update
    eng = Engine(deep_update(small, {**PARITY_40, "general": {
        "result_dir": str(tmp_path), "num_iter": 5}}), device="cpu",
        quiet=True)
    assert eng.mapper.spec.hash_spec.layout == "vertex"


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """configs/parity.yaml's grid on the 24x32 passive protocol, 40 steps,
    through the port's Engine on the host."""
    tmp = tmp_path_factory.mktemp("parity")
    cfg = make_config("Replica", "office0", num_iter=40, overrides={
        **PARITY_40, "general": {"result_dir": str(tmp), "seed": 0}})
    cfg = cfg.replace(enable_active_planning=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "eval_mesh", functools.partial(
            tengine.eval_mesh, n_samples=20_000))
        mp.setattr(tengine, "eval_mad", functools.partial(
            tengine.eval_mad, n_samples=20_000))
        eng = Engine(cfg, device="cpu", quiet=True)
        eng.run()
        eng.finalize()
    return eng, tmp / "Replica" / "office0"


def test_parity_run_metric_floors(parity_run):
    eng, run_dir = parity_run
    header, values = (run_dir / "eval_result.txt").read_text().strip() \
        .splitlines()[-2:]
    m = dict(zip(header.split(","), map(float, values.split(","))))
    assert eng.mapper.spec.hash_spec.layout == "vertex"
    assert m["completion_ratio_pct"] > FLOORS["completion_ratio_pct"], m
    assert m["mad_cm"] < FLOORS["mad_cm"], m
    assert m["completion_cm"] < FLOORS["completion_cm"], m
    assert m["accuracy_cm"] < FLOORS["accuracy_cm"], m


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vertex_checkpoint_loads_in_each_package(parity_run, tmp_path, rng,
                                                 writer):
    """A vertex-layout checkpoint written by one package (the port's after
    the 40 steps, the JAX package's at its initial weights) loads in the
    other: the same SDF (rel 1e-5) and the same poses."""
    mt = parity_run[0].mapper
    mj = jmapper.Mapper(mt.cfg)
    path = str(tmp_path / "ckpt.npz")
    if writer == "port":
        mt.save_ckpt(path)
        mj.load_ckpt(path)
        reader, other = mj, mt
    else:
        mj.save_ckpt(path)
        reader = Mapper(mt.cfg, device="cpu")
        reader.load_ckpt(path)
        other = mj
    assert isinstance(reader.cfg.grid.layout, str)
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    assert _rel_err(reader.predict_sdf(pts), other.predict_sdf(pts)) < 1e-5
    poses = [np.asarray(m.state.poses) if m is mj else m.poses.numpy()
             for m in (reader, other)]
    np.testing.assert_array_equal(*poses)


# the JAX engine's rows behind FLOORS and the records, outside tier-1:
#   PYTHONPATH=. python tests/test_torch_vertex.py OUT_DIR
# PARITY_40 as above; SETTINGS_40 adds tracking, importance samples, the
# Monte-Carlo smoothness and the weights carry on the hybrid grid
SETTINGS_40 = {**PARITY_40, "grid": {"hash_size": 12, "sort_carry": "weights"},
               "mapper": {**PARITY_40["mapper"], "tracking_enable": True,
                          "track_sample": 128, "track_ignore_edge_w": 2,
                          "track_ignore_edge_h": 2},
               "training": {**PARITY_40["training"], "n_importance": 4,
                            "smooth_sample": 256}}


def jax_rows(out_dir: str) -> dict:
    """The JAX engine's 40-step rows of PARITY_40 and SETTINGS_40, seed 0,
    20,000 evaluation samples (the port's tests' count)."""
    import naruto_tpu.evaluation as jeval
    from naruto_tpu.config import make_config as jmake_config
    from naruto_tpu.system.engine import Engine as JEngine

    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("eval_mesh", "eval_mad"):
            mp.setattr(jeval, name, functools.partial(getattr(jeval, name),
                                                      n_samples=20_000))
        for name, over in (("parity", PARITY_40), ("settings", SETTINGS_40)):
            run_dir = os.path.join(out_dir, name)
            cfg = jmake_config("Replica", "office0", num_iter=40, overrides={
                **over, "general": {"result_dir": run_dir, "seed": 0}})
            eng = JEngine(cfg.replace(enable_active_planning=False),
                          quiet=True)
            eng.run()
            eng.finalize()
            with open(os.path.join(run_dir, "Replica", "office0",
                                   "eval_result.txt")) as f:
                header, values = f.read().strip().splitlines()[-2:]
            rows[name] = dict(zip(header.split(","),
                                  map(float, values.split(","))))
    return rows


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    for k, row in jax_rows(sys.argv[1]).items():
        print(k, row)
