"""The port's data-parallel mapper (naruto_tpu_torch/parallel/) on two CPU
ranks over gloo, spawned by the package's rank worker: its sharded
gradient against the port's single-process gradient and the JAX package's
sharded gradient on the conftest's 8 virtual devices, the sharded volume
query against the unsharded one, the collectives each makes, the
unsharded fallback, the importance draws, the dryrun's engine loop with
its ranks bit-identical and only rank 0 writing, and the run CLI on two
ranks with a resume."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.config.schema import deep_update as jdeep_update
from naruto_tpu.mapping.mapper import Mapper as JMapper
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.mapping.mapper import Mapper
from naruto_tpu_torch.parallel import dryrun, mesh as pmesh
from naruto_tpu_torch.parallel.sharded import tree_leaves

from test_torch_tracking import _replay_smooth

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 2
N = 192                     # base + keep_cap of the active-ray batch shape
# tests/test_parallel.py's tolerances for the sharded production gradient
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)      # table and uncertainty grid
MLP_TOL = dict(rtol=1e-3, atol=1e-5)
VOL_TOL = dict(rtol=1e-5, atol=1e-6)
IMPORTANCE = {"training": {"n_importance": 4}}


def _graft_entry():
    s = importlib.util.spec_from_file_location(
        "graft_entry_torch", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.array(x))


def _functions_case():
    """tests/test_parallel.py's setup for the plain sharded functions: its
    field spec (in the JAX FieldSpec's default layout), render config and
    loss weights (no smoothness), 64 rays and 256 query points; the JAX
    package's sharded step and query on 8 devices, and the port's
    single-process loss and gradients."""
    from naruto_tpu.mapping.field import FieldSpec as JSpec, \
        init_field_params
    from naruto_tpu.mapping.losses import LossWeights as JLW
    from naruto_tpu.mapping.render import RenderConfig as JRC
    from naruto_tpu.parallel import (data_sharding, make_mesh, replicated,
                                     sharded_grad_step, sharded_volume_query)
    from naruto_tpu_torch.mapping.field import FieldSpec, volume_maps
    from naruto_tpu_torch.mapping.losses import LossWeights, total_loss
    from naruto_tpu_torch.mapping.render import RenderConfig, render_rays
    from naruto_tpu_torch.utils.ckpt_io import to_torch

    kw = dict(bound=((-1, 1), (-1, 1), (-1, 1)), n_levels=4,
              log2_hashmap_size=12, base_resolution=8, voxel_sdf=0.05,
              uncert_voxel_size=0.25, table_layout="vertex")
    jparams = init_field_params(jax.random.PRNGKey(0), JSpec(**kw))
    n = 64
    rays = (jnp.zeros((n, 3)),
            jnp.concatenate([jnp.zeros((n, 2)), jnp.ones((n, 1))], -1),
            jnp.full((n, 3), 0.5), jnp.full((n, 1), 0.7), jnp.ones((n,)))
    x01 = jax.random.uniform(jax.random.PRNGKey(2), (8 * 32, 3))
    mesh = make_mesh(8)
    data, repl = data_sharding(mesh), replicated(mesh)
    jspec = JSpec(**kw)
    (jloss, _), jgrads = sharded_grad_step(
        mesh, jspec, JRC(n_range_d=5, n_samples_d=8, perturb=0.0),
        JLW(smooth=0.0))(jax.device_put(jparams, repl),
                         *[jax.device_put(a, data) for a in rays],
                         jax.random.PRNGKey(1))
    jsdf, jum = sharded_volume_query(mesh, jspec)(
        jax.device_put(jparams, repl), jax.device_put(x01, data))
    spec, rc = FieldSpec(**kw), RenderConfig(n_range_d=5, n_samples_d=8,
                                             perturb=0.0)
    lw = LossWeights(smooth=0.0)
    params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = to_torch(params)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    args = [_t(a) for a in rays]
    rend = render_rays(tparams, spec, rc, args[0], args[1], args[3], None)
    loss, _ = total_loss(rend, args[2], args[3], args[4], lw,
                         with_smooth=False)
    with torch.no_grad():
        vols = volume_maps(tparams, _t(x01), spec)
    return {"payload": {"spec": spec, "rc": rc, "lw": lw, "params": params,
                        "args": args, "x01": _t(x01)},
            "loss": float(loss.detach()), "leaves": leaves,
            "grads": torch.autograd.grad(loss, leaves), "volumes": vols,
            "jax": (float(jloss), jgrads, np.asarray(jsdf),
                    np.asarray(jum))}


def _jax_grads(jm, params, key, batch):
    return jax.jit(jm._grad_fn, static_argnums=(7,))(params, key, *batch,
                                                     True)


@pytest.fixture(scope="module")
def setup():
    """The JAX sharded mapper (8 devices) and its gradient on tests/
    test_parallel.py's batch; the same weights, batch and replayed draws
    through the port on RANKS ranks and in this process. Beside it, the
    same with importance samples: the JAX package's sharded and unsharded
    gradients, and the port's on RANKS ranks and in this process from one
    full-batch draw."""
    jcfg = _graft_entry().tiny_mapper_config(8)
    jm = JMapper(jcfg)
    assert jm._ba_mesh is not None and jm._ba_ndev == 8
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    rays_o = jax.random.normal(k1, (N, 3)) * 0.1
    rays_d = jnp.concatenate(
        [jax.random.normal(k2, (N, 2)) * 0.2, jnp.ones((N, 1))], -1)
    batch = (rays_o, rays_d, jnp.full((N, 3), 0.4), jnp.full((N, 1), 0.9),
             jnp.ones((N,)))
    g_jax = _jax_grads(jm, jm.state.params, k3, batch)
    # the sharded JAX path's draws: z-noise on the unsplit batch from the
    # render key, the smoothness lattice from the other half of the split
    k_render, k_smooth = jax.random.split(k3)
    z_noise = _t(jax.random.uniform(k_render, (N, jm.rc.n_samples)))
    smooth = tuple(_replay_smooth(k_smooth, jm.lw)) + (None, None)
    args = [_t(a) for a in batch] + [z_noise]
    params = jax.tree_util.tree_map(np.asarray, jm.state.params)
    cfg = dryrun.tiny_mapper_config(RANKS)
    # RANKS does not divide N - 1: that call runs unsharded
    calls = [{"args": args, "smooth": smooth},
             {"args": [a[:N - 1] for a in args], "smooth": smooth}]
    # importance samples: one U[0, 1) draw for the whole batch
    imp_cfg = deep_update(cfg, IMPORTANCE)
    imp_call = {"args": args, "smooth": smooth, "importance_u": _t(
        jax.random.uniform(jax.random.fold_in(k_render, 1), (N, 4)))}
    fn = _functions_case()
    res = dryrun.spawn(
        "naruto_tpu_torch.parallel.dryrun:grads_target", RANKS, {
            "mappers": [
                {"cfg": cfg, "params": params, "calls": calls},
                {"cfg": imp_cfg, "params": params, "calls": [imp_call]}],
            "functions": fn["payload"]}, device="cpu")
    ranks, imp_ranks = zip(*[r["mappers"] for r in res])
    single = Mapper(cfg, device="cpu")
    assert single.mesh is None and single._ba_mesh is None
    single.load_weights(params)
    refs = [single._grad_fn(*c["args"], smooth=c["smooth"]) for c in calls]
    vols = [v.clone() for v in single.map_volumes()]
    imp_single = Mapper(imp_cfg, device="cpu")
    imp_single.load_weights(params)
    imp_ref = imp_single._grad_fn(*imp_call["args"], smooth=smooth,
                                  importance_u=imp_call["importance_u"])
    jimp = [JMapper(jdeep_update(jcfg, {**IMPORTANCE, "parallel": {
        "shard_rays": sharded}})) for sharded in (True, False)]
    g_jimp = [_jax_grads(m, jm.state.params, k3, batch) for m in jimp]
    return {"ranks": ranks, "refs": refs, "vols": vols, "g_jax": g_jax,
            "single": single, "imp_ranks": imp_ranks, "imp_ref": imp_ref,
            "g_jax_imp": g_jimp, "functions": fn,
            "fn_ranks": [r["functions"] for r in res]}


def _pairs(grads):
    """(leaf, tolerance) in table_leaves, decoder, uncertainty order."""
    return ([(g, TABLE_TOL) for g in grads["table"]]
            + [(g, MLP_TOL) for g in grads["decoder"]]
            + [(g, TABLE_TOL) for g in grads["uncert"]])


def test_sharded_grads_match_single_process(setup):
    """2 ranks against the port's single-process _grad_fn: every leaf at
    tests/test_parallel.py's tolerances, the loss terms at 1e-5; the ranks'
    gradients bit-identical."""
    ranks, refs = setup["ranks"], setup["refs"]
    assert all(r["sharded"] for r in ranks)
    aux_ref, g_ref = refs[0]
    for r in ranks:
        aux, grads = r["calls"][0]["aux"], r["calls"][0]["grads"]
        for (got, tol), want in zip(_pairs(grads),
                                    [g for g, _ in _pairs(g_ref)]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
        assert set(aux) == set(aux_ref)
        for k in aux:
            assert float(aux[k]) == pytest.approx(float(aux_ref[k]),
                                                  rel=1e-5), k
        assert "smooth_loss" in aux
    for a, b in zip(_pairs(ranks[0]["calls"][0]["grads"]),
                    _pairs(ranks[1]["calls"][0]["grads"])):
        assert torch.equal(a[0], b[0])


def test_sharded_grads_match_jax_sharded(setup):
    """2 ranks against the JAX package's shard_map gradient on 8 virtual
    devices (the same weights, batch and draws)."""
    ranks, g_jax = setup["ranks"], setup["g_jax"]
    ref = [g_jax["table"]["hash"], *g_jax["table"]["dense"],
           *g_jax["sdf_mlp"], *g_jax["color_mlp"], g_jax["uncert_grid"]]
    got = _pairs(ranks[0]["calls"][0]["grads"])
    assert len(got) == len(ref)
    for (g, tol), want in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **tol)


def test_collectives_per_call(setup):
    """One all-reduce of the loss denominators and one of the gradient
    bucket per sharded gradient; one per volume query; none else."""
    ranks = setup["ranks"]
    zero = {k: 0 for k in pmesh.COLLECTIVES}
    for r in ranks:
        assert r["calls"][0]["collectives"] == {**zero, "denominators": 1,
                                                "gradients": 1}
        assert r["volume_collectives"] == {**zero, "volumes": 1}


def test_indivisible_batch_runs_unsharded(setup):
    """N - 1 rays do not split over 2 ranks: no collective, and each rank's
    gradient is the single-process one, bit for bit."""
    ranks, refs = setup["ranks"], setup["refs"]
    for r in ranks:
        call = r["calls"][1]
        assert call["collectives"] == {k: 0 for k in pmesh.COLLECTIVES}
        for a, b in zip(_pairs(call["grads"]), _pairs(refs[1][1])):
            assert torch.equal(a[0], b[0])


def test_sharded_volume_query(setup):
    """729 voxels (one padded) split over 2 ranks and gathered: the
    unsharded query's volumes on every rank."""
    ranks, vols, single = setup["ranks"], setup["vols"], setup["single"]
    assert vols[0].numel() == 729 and pmesh.pad_to(729, RANKS) == 730
    for r in ranks:
        for got, want in zip(r["volumes"], vols):
            assert got.shape == want.shape == tuple(single.vol_shape)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **VOL_TOL)
    for a, b in zip(ranks[0]["volumes"], ranks[1]["volumes"]):
        assert torch.equal(a, b)


def _leaves(g):
    return [g["table"]["hash"], *g["table"]["dense"], *g["sdf_mlp"],
            *g["color_mlp"], g["uncert_grid"]]


def test_importance_draw_is_the_full_batch(setup):
    """With importance samples the JAX package's sharded gradient is not
    its unsharded one (each shard draws its u from the replicated key at
    its own shape), while the port slices one full-batch draw: its 2-rank
    gradient is its single-process one, a deviation made on purpose."""
    sharded, whole = (_leaves(g) for g in setup["g_jax_imp"])
    assert not all(np.allclose(np.asarray(a), np.asarray(b), **TABLE_TOL)
                   for a, b in zip(sharded[:3], whole[:3]))
    ref = setup["imp_ref"][1]
    for r in setup["imp_ranks"]:
        assert r["sharded"]
        for (got, tol), want in zip(_pairs(r["calls"][0]["grads"]),
                                    [g for g, _ in _pairs(ref)]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_sharded_functions(setup):
    """sharded_grad_step and sharded_volume_query as plain functions over a
    field, as tests/test_parallel.py uses the JAX ones: on 2 ranks, the
    port's single-process loss (1e-5) and gradients (that test's 1e-4 /
    1e-7) and the whole query on every rank; against the JAX package's on
    8 devices at the production tolerances."""
    fn = setup["functions"]
    jloss, jgrads, jsdf, jum = fn["jax"]
    jleaves = tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    for r in setup["fn_ranks"]:
        assert r["loss"] == pytest.approx(fn["loss"], rel=1e-5)
        assert r["loss"] == pytest.approx(jloss, rel=1e-5)
        got = tree_leaves(r["grads"])
        assert len(got) == len(fn["grads"]) == len(jleaves)
        for a, b, c in zip(got, fn["grads"], jleaves):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-7)
            np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                       **TABLE_TOL)
        sdf, um = r["volumes"]
        np.testing.assert_allclose(sdf.numpy(), fn["volumes"][0].numpy(),
                                   **VOL_TOL)
        np.testing.assert_allclose(um.numpy(), fn["volumes"][1].numpy(),
                                   **VOL_TOL)
        np.testing.assert_allclose(sdf.numpy(), jsdf, **VOL_TOL)
        np.testing.assert_allclose(um.numpy(), jum, **VOL_TOL)
        assert np.all(um.numpy() >= 0)


def test_mesh_helpers():
    assert pmesh.shard_slice(192, 2, 1) == slice(96, 192)
    with pytest.raises(ValueError):
        pmesh.shard_slice(191, 2, 0)
    assert [pmesh.pad_to(n, 3) for n in (96_040, 96_039, 1)] == \
        [96_042, 96_039, 3]
    assert pmesh.choose_backend("cuda", 2, 2) == "nccl"
    assert pmesh.choose_backend("cuda", 2, 1) == "gloo"
    assert pmesh.choose_backend("cpu", 2, 0) == "gloo"
    assert pmesh.make_mesh("cpu") is None      # no launcher, one rank


def test_timed_collectives(tmp_path):
    """Within timed_collectives every collective is counted as outside it
    and its wall is added to its site; outside, nothing is timed."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0)
    try:
        pmesh.reset_collective_counts()
        t = torch.arange(4.0)
        with pmesh.timed_collectives() as spent:
            pmesh.all_reduce(t, "gradients")
            pmesh.all_reduce(t, "gradients")
            pmesh.all_reduce(t, "denominators")
        assert spent["gradients"] > 0 and spent["denominators"] > 0
        assert spent["volumes"] == spent["checksum"] == 0
        assert torch.equal(t, torch.arange(4.0))
        before = dict(spent)
        pmesh.all_reduce(t, "volumes")
        assert spent == before
        assert pmesh.collective_counts() == {
            "denominators": 1, "gradients": 2, "volumes": 1, "checksum": 0}
    finally:
        torch.distributed.destroy_process_group()


def test_ranks_default_to_the_card(monkeypatch):
    """spawn and dryrun_multichip run their ranks on the card unless the
    caller asks for the CPU: without one they raise before any rank
    starts, naming device='cpu'; the rank worker takes no default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(dryrun.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.spawn("naruto_tpu_torch.parallel.dryrun:run_target", RANKS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(RANKS)
    assert started == []
    with pytest.raises(SystemExit):
        dryrun._worker(["--target", "m:f", "--workdir", "."])


def test_dryrun_ranks_agree_and_only_rank0_writes(tmp_path):
    """The dryrun (first frame, BA through frame 5, then the active engine
    loop cut to 20 steps) at 2 ranks: fields and poses bit-identical
    (dryrun_multichip raises otherwise), and only rank 0's directory on
    disk."""
    res = dryrun.dryrun_multichip(RANKS, device="cpu", num_iter=20,
                                  result_dir=str(tmp_path))
    assert [r["lead"] for r in res] == [True, False]
    run0 = tmp_path / "rank0" / "Replica" / "office0"
    assert (run0 / "config.json").exists()
    assert (run0 / "mesh" / "mesh_0000.ply").exists()
    assert not (tmp_path / "rank1").exists()
    assert res[0]["planner"]["state_steps"]
    assert np.isfinite(res[0]["final_c2w"]).all()


def _sharded_yaml(tmp_path):
    """test_torch_resume.py's 12-step passive YAML (a snapshot every 5
    steps) with the ray and voxel axes sharded."""
    import yaml

    from test_torch_resume import _tiny_yaml

    path = pathlib.Path(_tiny_yaml(tmp_path, 5))
    cfg = yaml.safe_load(path.read_text())
    cfg["parallel"] = {"shard_rays": True, "shard_volumes": True}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _final_ckpt(run_dir):
    with np.load(run_dir / "ckpt_0012_final.pkl") as z:
        return {k: z[k] for k in z.files if k.startswith("leaf:")}


def test_cli_two_ranks_resume(tmp_path, capsys):
    """`python -m naruto_tpu_torch.run` on 2 ranks as torchrun starts it:
    the first line names the ranks and the backend, rank 0 alone prints
    and writes; then both ranks resume from the snapshot rank 0 wrote and
    end with the unbroken run's checkpoint, array for array."""
    base = ["--cfg", _sharded_yaml(tmp_path), "--device", "cpu",
            "--result_dir", str(tmp_path / "a")]
    target = "naruto_tpu_torch.parallel.dryrun:run_target"
    dryrun.spawn(target, RANKS, base, device="cpu")
    out = capsys.readouterr().out
    first = next(ln for ln in out.splitlines() if ln.startswith("[rank 0]"))
    assert first == ("[rank 0] [parallel] 2 ranks, backend gloo (host); "
                     "rank 0 on cpu")
    assert "[rank 0] [run] wall:" in out
    assert "[rank 1]" not in out
    run_a = tmp_path / "a" / "Replica" / "office0"
    unbroken = _final_ckpt(run_a)
    assert (run_a / "full_state_latest.pkl").exists()
    (run_a / "ckpt_0012_final.pkl").unlink()
    dryrun.spawn(target, RANKS, base + ["--resume", "auto"], device="cpu")
    out = capsys.readouterr().out
    assert "starting fresh" not in out
    resumed = _final_ckpt(run_a)
    assert list(resumed) == list(unbroken)
    for k in unbroken:
        np.testing.assert_array_equal(resumed[k], unbroken[k], err_msg=k)
