"""Descriptor-DB assembly: the port against sgtd_tpu.db on the same
descriptors. All 14 DescriptorDB fields must be equal (uint32 words as
their int32 bit patterns), as must the build report, the calibration
totals and the fitted scan cap."""

import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import DescriptorDB as JaxDescriptorDB
from sgtd_tpu.db.database import save_database
from sgtd_tpu.db.device_build import build_database_calibrated as jax_build_calibrated
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match.search import fit_scan_slots as jax_fit_scan_slots
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.db.device_build import build_database_calibrated
from sgtd_tpu_torch.match.search import fit_scan_slots

torch.set_num_threads(1)

# 2^21 slots hold the small world's direct table; 2^16 do not, and both
# packages then empty it (the bisection fallback's layout).
@pytest.fixture(scope="module", params=[1 << 21, 1 << 16], ids=["direct_table", "table_over_budget"])
def built(small_config, request):
    cfg = small_config
    maps, queries, _ = make_map_and_queries(
        cfg, seed=7, num_map_frames=24, num_queries=8,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    fn = jax.jit(jax.vmap(functools.partial(jax_build_descriptors, cfg=cfg.desc, caps=cfg.caps)))
    stack = lambda gs: jax.tree_util.tree_map(lambda *xs: np.stack(xs), *gs)
    map_descs = jax.tree_util.tree_map(np.asarray, fn(stack(maps)))
    sample = jax.tree_util.tree_map(np.asarray, fn(stack(queries[:4])))
    poses = np.stack([g.pose for g in maps])
    want = jax_build_calibrated(map_descs, poses, sample, cfg.desc, table_slots=request.param)
    got = build_database_calibrated(
        interop.descriptors_from_numpy(map_descs, "cpu"), torch.from_numpy(poses),
        interop.descriptors_from_numpy(sample, "cpu"), cfg.desc, table_slots=request.param,
    )
    return cfg, want, got


def _assert_db_equal(got: DescriptorDB, want) -> None:
    got_np = interop.db_to_numpy(got)
    for f in DescriptorDB._fields:
        w = np.asarray(getattr(want, f))
        assert got_np[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got_np[f], w, err_msg=f)


def test_db_fields_match_reference(built):
    _, (want_db, _, _), (got_db, _, _) = built
    assert DescriptorDB._fields == JaxDescriptorDB._fields
    assert got_db.has_direct_table == want_db.has_direct_table
    assert got_db.packed2.dtype == torch.int32  # uint32 words as int32 bits
    _assert_db_equal(got_db, want_db)


def test_report_totals_and_scan_cap_match_reference(built):
    cfg, (_, want_rep, want_tot), (_, got_rep, got_tot) = built
    assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)
    assert got_rep.suggested_bucket_cap == want_rep.suggested_bucket_cap
    np.testing.assert_array_equal(got_tot.numpy(), np.asarray(want_tot))
    for observed in (int(got_tot.max()), 0, 123_456_789):
        assert fit_scan_slots(observed, cfg) == jax_fit_scan_slots(observed, cfg)


def test_load_database_reads_reference_file(built, tmp_path):
    _, (want_db, _, _), _ = built
    path = str(tmp_path / "map.npz")
    save_database(path, want_db)
    _assert_db_equal(interop.load_database(path, "cpu"), want_db)
    _assert_db_equal(interop.db_from_numpy(want_db, "cpu"), want_db)


def test_load_database_rejects_other_format(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, format_version=np.int32(1), keys=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="format v1"):
        interop.load_database(path, "cpu")
