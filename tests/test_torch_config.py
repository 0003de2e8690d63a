"""The port's own copies of the config tree and the geometry helpers
against naruto_tpu's: equal field for field, and equal outputs."""
import dataclasses
import pathlib

import numpy as np
import pytest

from naruto_tpu import config as jcfg
from naruto_tpu.geometry import rays as jrays
from naruto_tpu.geometry import voxel as jvoxel
from naruto_tpu_torch import config as tcfg
from naruto_tpu_torch.geometry import rays as trays
from naruto_tpu_torch.geometry import voxel as tvoxel

SCENES = [(ds, sc) for ds, scenes in jcfg.list_scenes().items()
          for sc in scenes]


def test_list_scenes_matches_jax():
    assert tcfg.list_scenes() == jcfg.list_scenes()


@pytest.mark.parametrize("dataset,scene", SCENES)
def test_make_config_matches_jax(dataset, scene):
    got = dataclasses.asdict(tcfg.make_config(dataset, scene))
    want = dataclasses.asdict(jcfg.make_config(dataset, scene))
    assert got == want


def test_make_config_overrides_match_jax():
    over = {"mapper": {"iters": 3, "sample": 64}, "grid": {"hash_size": 12},
            "cam": {"H": 24, "W": 32}}
    got = tcfg.make_config("MP3D", "HxpKQynjfin", seed=7, num_iter=40,
                           overrides=over)
    want = jcfg.make_config("MP3D", "HxpKQynjfin", seed=7, num_iter=40,
                            overrides=over)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        tcfg.make_config("Replica", "office0", overrides={"nope": 1})


@pytest.mark.parametrize("args", [
    (680, 1200, 600.0, 600.0, 599.5, 339.5),
    (24, 32, 16.0, 16.0, None, None),
    (7, 5, 3.0, 4.0, 2.2, 3.3, "OpenGL")])
def test_camera_rays_match_jax(args):
    np.testing.assert_array_equal(trays.get_camera_rays(*args),
                                  jrays.get_camera_rays(*args))


@pytest.mark.parametrize("dataset,scene,voxel", [
    ("Replica", "office0", 0.1), ("MP3D", "YmJkqBEsHnH", 0.1),
    ("NARUTO", "naruto", 0.02)])
def test_volume_helpers_match_jax(dataset, scene, voxel):
    bound = tcfg.make_config(dataset, scene).mapper.bound_np
    assert tvoxel.volume_shape(bound, voxel) == \
        jvoxel.volume_shape(bound, voxel)
    np.testing.assert_array_equal(tvoxel.world_grid(bound, voxel),
                                  jvoxel.world_grid(bound, voxel))


@pytest.mark.parametrize("path", sorted(
    str(p) for p in pathlib.Path(__file__).resolve().parents[1].glob(
        "configs/**/*.yaml")))
def test_load_config_matches_jax(path):
    """Every shipped YAML experiment file (inherit_from chains included)
    loads to the same config in both packages."""
    assert dataclasses.asdict(tcfg.load_config(path)) == \
        dataclasses.asdict(jcfg.load_config(path))
