"""The port's host DB build and DB files against sgtd_tpu.db.database on
the same descriptors. ``build_database`` must give the reference's
``build_database`` field for field (uint32 words as their int32 bit
patterns) and the same report, and the port's ``db.device_build`` the same
fields on the rows both hold: the device build pads the row axis to F * D
where the host build pads to a multiple of 128, and every row beyond the
host's is padding. A DB saved by either package loads in the other. No
tolerance: every field is integer or copied."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db import database as jax_database
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.db import database
from sgtd_tpu_torch.db.database import PAD_KEY, DescriptorDB
from sgtd_tpu_torch.db.device_build import build_database_on_device

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(small_config):
    """Per-frame reference descriptors of a small world, as NumPy arrays."""
    cfg = small_config
    maps, _, _ = make_map_and_queries(cfg, seed=21, num_map_frames=13, num_queries=1,
                                      center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
    fn = jax.jit(lambda g: jax_build_descriptors(g, cfg.desc, cfg.caps))
    descs = [jax.tree_util.tree_map(np.asarray, fn(g)) for g in maps]
    poses = [np.asarray(g.pose) for g in maps]
    return cfg, descs, poses


def _assert_equal(got: DescriptorDB, want) -> None:
    got_np = interop.db_to_numpy(got)
    for f in DescriptorDB._fields:
        w = np.asarray(getattr(want, f))
        assert got_np[f].dtype == w.dtype and got_np[f].shape == w.shape, f
        np.testing.assert_array_equal(got_np[f], w, err_msg=f)


@pytest.mark.parametrize("slots", [1 << 21, 1 << 12], ids=["direct_table", "table_over_budget"])
def test_host_build_matches_reference(world, slots):
    cfg, descs, poses = world
    caps = dataclasses.replace(cfg.caps, bucket_table_slots=slots)
    want_db, want_rep = jax_database.build_database(descs, poses, cfg.desc, caps)
    port_descs = [interop.descriptors_from_numpy(d, "cpu") for d in descs]
    pcfg = interop.config_from_reference(cfg)
    pcaps = dataclasses.replace(pcfg.caps, bucket_table_slots=slots)
    got_db, got_rep = database.build_database(port_descs, [torch.from_numpy(p) for p in poses], pcfg.desc, pcaps,
                                              device="cpu")
    assert got_db.keys.device.type == "cpu" and got_db.packed2.dtype == torch.int32
    assert got_db.has_direct_table == want_db.has_direct_table == (slots == 1 << 21)
    _assert_equal(got_db, want_db)
    assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)
    # Stacked NumPy input gives the same DB.
    again, _ = database.build_database_stacked(jax_database.stack_descriptor_arrays(descs), np.stack(poses),
                                               pcfg.desc, pcaps, device="cpu")
    _assert_equal(again, want_db)


def test_host_build_matches_device_build(world):
    """Field for field with db.device_build on the same descriptors, on the
    rows the host build holds; the device build's extra rows are padding."""
    cfg, descs, poses = world
    pcfg = interop.config_from_reference(cfg)
    stacked = interop.descriptors_from_numpy(jax_database.stack_descriptor_arrays(descs)._replace(
        angles=np.stack([d.angles for d in descs]), node_ids=np.stack([d.node_ids for d in descs]),
        center=np.stack([d.center for d in descs])), "cpu")
    poses_t = torch.from_numpy(np.stack(poses))
    host, host_rep = database.build_database_stacked(stacked, poses_t, pcfg.desc, pcfg.caps, device="cpu")
    dev, dev_rep = build_database_on_device(stacked, poses_t, pcfg.desc, table_slots=pcfg.caps.bucket_table_slots)
    m = host.keys.shape[0]
    assert dev.keys.shape[0] >= m and bool((dev.keys[m:] == PAD_KEY).all())
    rows = dict(keys=m, codes=m, packed2=m, vertices=m, frame_ids=m, frame_rows=m)
    for f in DescriptorDB._fields:
        a, b = getattr(host, f), getattr(dev, f)
        if f in rows:
            b = b[: rows[f]]
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    for k in ("num_rows", "num_frames", "num_cells", "max_bucket", "max_cell_bucket"):
        assert getattr(host_rep, k) == getattr(dev_rep, k), k


def test_empty_and_single_frame_builds_match_reference(world):
    cfg, descs, poses = world
    pcfg = interop.config_from_reference(cfg)
    empty = descs[0]._replace(mask=np.zeros_like(descs[0].mask))
    for case in ([empty], [descs[3]], [empty, descs[3]]):
        want_db, want_rep = jax_database.build_database(case, poses[: len(case)], cfg.desc, cfg.caps)
        got_db, got_rep = database.build_database([interop.descriptors_from_numpy(d, "cpu") for d in case],
                                                  poses[: len(case)], pcfg.desc, pcfg.caps, device="cpu")
        _assert_equal(got_db, want_db)
        assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("slots", [1 << 21, 1 << 12], ids=["direct_table", "table_over_budget"])
def test_db_files_cross_packages(world, tmp_path, writer, slots):
    cfg, descs, poses = world
    caps = dataclasses.replace(cfg.caps, bucket_table_slots=slots)
    want_db, _ = jax_database.build_database(descs, poses, cfg.desc, caps)
    path = str(tmp_path / "db.npz")
    if writer == "port":
        database.save_database(path, interop.db_from_numpy(want_db, "cpu"))
        with np.load(path) as z:
            assert int(z["format_version"]) == jax_database.DB_FORMAT_VERSION == database.DB_FORMAT_VERSION
            assert z["packed2"].dtype == np.uint32 and z["bucket_table"].dtype == np.uint32
        back = jax_database.load_database(path)
        for f in DescriptorDB._fields:
            np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(want_db, f)), err_msg=f)
    else:
        jax_database.save_database(path, want_db)
    for loader in (database.load_database, interop.load_database):
        _assert_equal(loader(path, "cpu"), want_db)


def test_old_db_file_raises_rebuild(world, tmp_path):
    """A pre-packed2 (v1) file fails with a rebuild message, as in the
    reference (test_bucket_table.py)."""
    cfg, descs, poses = world
    want_db, _ = jax_database.build_database(descs, poses, cfg.desc, cfg.caps)
    fields = {k: np.asarray(v) for k, v in want_db._asdict().items()}
    del fields["packed2"]
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **fields)
    with pytest.raises(ValueError, match="rebuild"):
        database.load_database(path, "cpu")
    with pytest.raises(ValueError, match="rebuild"):
        jax_database.load_database(path)
