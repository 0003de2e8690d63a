"""The map-volume query in chunks (naruto_tpu_torch/mapping/field.py
``chunked_volume_maps``, ``Mapper.map_volumes``) on the CPU: the chunks'
volumes against the one-batch query on the hybrid and vertex grids, the
uncertainty volume at its address, the chunk counter, the spans of the
query and of the host copy, and the sharded query's rank blocks in
chunks."""
import numpy as np
import pytest
import torch

from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.mapping import field
from naruto_tpu_torch.mapping.field import volume_maps
from naruto_tpu_torch.mapping.mapper import Mapper
from naruto_tpu_torch.parallel import sharded
from naruto_tpu_torch.parallel.mesh import Mesh
from naruto_tpu_torch.utils.timer import SPANS, SpanStore

torch.set_num_threads(1)

BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))
# 17^3 = 4,913 voxels: 7 chunks of 700 and a last one of 13
VOXEL, CHUNK = 0.25, 700
# each point's values depend on that point alone, but the CPU sums the
# eight corner terms of the uncertainty grid's trilinear blend in another
# order in a chunk's last rows (its vector loop's remainder): 1 float32
# ulp on one voxel here, under 1e-6 of the value
CHUNK_TOL = dict(rtol=1e-6, atol=0.0)
LAYOUTS = {"hybrid": {"n_levels": 4, "n_features_per_level": 8,
                      "table_dtype": "bfloat16", "layout": "hybrid"},
           "vertex": {"n_levels": 16, "n_features_per_level": 2,
                      "table_dtype": "float32", "layout": "vertex"}}


def _mapper(layout: str) -> Mapper:
    """A CPU mapper whose table and uncertainty grid are trained a little
    (one first-frame call), so the volumes hold a surface band."""
    cfg = make_config("Replica", "office0", num_iter=40, overrides={
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": dict(LAYOUTS[layout], hash_size=12, voxel_sdf=0.1),
        "mapper": {"sample": 64, "iters": 2, "first_iters": 3,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "bound": BOUND, "marching_cubes_bound": BOUND,
                   "voxel_size": VOXEL},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4}})
    m = Mapper(cfg, device="cpu")
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 1.5, (24, 32)).astype(np.float32)
    color = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    m.update_step(0)
    m.online_recon_step(0, color, depth, np.eye(4, dtype=np.float32))
    return m


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def mapper(request):
    return _mapper(request.param)


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(field, "VOLUME_CHUNK", CHUNK)


def _one_batch(m: Mapper):
    with torch.no_grad():
        sdf, unc = volume_maps(m.params, m.grid01, m.spec)
    return unc.reshape(m.vol_shape), sdf.reshape(m.vol_shape)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHUNK_TOL)


@pytest.mark.parametrize("chunk", [CHUNK, 4913, 1 << 18])
def test_chunked_volumes_equal_the_one_batch_query(mapper, monkeypatch,
                                                   chunk):
    """Several chunks and a short last one: the one-batch query's volumes
    to CHUNK_TOL; one chunk, exact or the default's (as office0's 96,040
    voxels take): bit for bit. A surface band in them."""
    monkeypatch.setattr(field, "VOLUME_CHUNK", chunk)
    assert mapper.grid01.shape[0] == 17 ** 3
    u, s = mapper.map_volumes()
    want_u, want_s = _one_batch(mapper)
    if chunk >= 4913:
        assert torch.equal(s, want_s) and torch.equal(u, want_u)
    _close(s, want_s)
    _close(u, want_u)
    assert 0 < int((u > 0).sum()) < u.numel()


def test_uncertainty_volume_keeps_its_address(mapper, small_chunks):
    """The captured BA call reads uncert_vol at a fixed address: the
    chunked query refreshes it in place, and the SDF is a volume of its
    own each query."""
    addr = mapper.uncert_vol.data_ptr()
    u1, s1 = mapper.map_volumes()
    u2, s2 = mapper.map_volumes()
    assert u1 is u2 is mapper.uncert_vol
    assert mapper.uncert_vol.data_ptr() == addr
    assert s1.data_ptr() != s2.data_ptr() and torch.equal(s1, s2)


def test_volume_counts_count_chunks(mapper, small_chunks):
    field.reset_volume_counts()
    mapper.map_volumes()
    mapper.get_map_volumes_lazy()
    assert field.volume_counts() == {"queries": 2, "chunks": 16,
                                     "voxels": 2 * 4913}
    field.reset_volume_counts()
    assert field.volume_counts() == {"queries": 0, "chunks": 0, "voxels": 0}


def test_query_and_host_copy_spans(mapper, small_chunks):
    """A lazy query is one volumes.query span; each host copy one
    volumes.host span carrying the volume's index, the first read only.
    The CPU records no device time."""
    before = max((r.id for r in SPANS.records()), default=-1)
    vols = mapper.get_map_volumes_lazy()
    sdf = vols.host(1)
    vols.host(1)
    vols.host(0)
    recs = [r for r in SPANS.records() if r.id > before]
    assert [(r.name, r.arg) for r in recs] == [
        ("volumes.query", None), ("volumes.host", 1), ("volumes.host", 0)]
    assert all(r.end_ns >= r.start_ns for r in recs)
    _close(torch.from_numpy(sdf), _one_batch(mapper)[1])
    assert SPANS.device_ms("volumes.query") == []


def test_timed_span_on_the_cpu_is_a_span():
    store = SpanStore()
    with store.timed("x", torch.device("cpu")):
        pass
    (rec,) = store.records()
    assert (rec.name, rec.parent) == ("x", -1)
    assert store.device_ms("x") == []


def test_sharded_rank_blocks_in_chunks(mapper, small_chunks, monkeypatch):
    """Two ranks' shares of 4,913 voxels (2,457 each, one padded), each in
    chunks of 700 and a short last one, written into the rank's block:
    the blocks together are the one-batch volumes."""
    blocks = []

    def keep(local, n, mesh, site):
        blocks.append(local.clone())
        return local.new_zeros((n,) + tuple(local.shape[1:]))

    monkeypatch.setattr(sharded, "gather_blocks", keep)
    for rank in range(2):
        query = sharded.sharded_volume_query(
            Mesh(2, rank, torch.device("cpu"), "gloo"), mapper.spec)
        query(mapper.params, mapper.grid01)
    full = torch.cat(blocks)[:4913]
    want_u, want_s = _one_batch(mapper)
    _close(full[:, 0], want_s.reshape(-1))
    _close(full[:, 1], want_u.reshape(-1))
    assert torch.equal(blocks[1][-1], torch.zeros(2))

