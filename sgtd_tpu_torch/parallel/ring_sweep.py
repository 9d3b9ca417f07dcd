"""Ring-sweep localization: DB blocks rotate, queries stay put (port of
sgtd_tpu.parallel.ring_sweep).

The scaling mode for maps beyond what one rank's memory holds: the mesh's
``dp`` dim carries the query scans and the DB, split into one block of rows
a rank (``shard_database(db, mesh, axis="dp")``); its ``db`` dim is 1. Over
n ring steps every rank scans every block:

  step s: rank d holds block b = (d - s) mod n
          votes += probe_and_hits(block b, my queries)
          the kept hits' frames and vertices are banked (verification
          never needs a block that has moved on)
          block -> rank d + 1

Then top-K candidates from the summed votes, pair lists from the banked
hits, batched verification: the single-device pipeline's result up to the
per-block hit quotas.
"""

from __future__ import annotations

import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.graph.types import SemanticGraph
from sgtd_tpu_torch.match.pipeline import LocalizationResult, rank_candidates
from sgtd_tpu_torch.match.search import (
    TRUNC_PAIRS,
    TRUNC_SCAN,
    CandidateSet,
    extract_pairs,
    probe_and_hits,
    select_candidates,
)
from sgtd_tpu_torch.match.verify import verify_pairs
from sgtd_tpu_torch.parallel.mesh import ROW_FIELDS, axis_index, axis_size, ppermute_next
from sgtd_tpu_torch.utils import batch_take, disable_tf32


def make_ring_localizer(mesh, config: SGTDConfig = SGTDConfig()):
    """A callable ``(db_block, graphs_local) -> LocalizationResult`` for
    this rank, on a mesh whose ``db`` dim is 1: ``db_block`` is this rank's
    block of DB rows (block index = its ``dp`` coordinate, as
    ``shard_database(db, mesh, axis="dp")`` gives it), ``graphs_local`` its
    slice of the query batch along ``dp``. Every rank calls it the same
    number of times."""
    if axis_size(mesh, "db") != 1:
        raise ValueError(f"the ring sweeps over 'dp'; the mesh's 'db' dim must be 1, not {axis_size(mesh, 'db')}")
    n = axis_size(mesh, "dp")
    my = axis_index(mesh, "dp")
    caps = config.caps

    def localize_ring(db_block: DescriptorDB, graphs_local: SemanticGraph) -> LocalizationResult:
        disable_tf32()
        query = build_descriptors(graphs_local, config.desc, caps)
        bsz, d_max = query.mask.shape
        u = caps.hits_per_descriptor
        m_block = db_block.keys.shape[0]
        f_pad = db_block.frame_poses.shape[0]
        dev = query.sides.device
        block = [getattr(db_block, f) for f in ROW_FIELDS]
        votes = torch.zeros((bsz, f_pad), dtype=torch.float32, device=dev)
        truncated = torch.zeros(bsz, dtype=torch.int32, device=dev)
        bank_frame = torch.full((bsz, n, d_max, u), f_pad, dtype=torch.int32, device=dev)
        bank_verts = torch.zeros((bsz, n, d_max, u, 3, 3), dtype=torch.float32, device=dev)
        for s in range(n):
            # Blocks travel to rank d + 1, so rank d holds block (d - s) mod n.
            b = (my - s) % n
            sub = db_block._replace(**dict(zip(ROW_FIELDS, block)))
            ph = probe_and_hits(sub, query, config.desc, config.search, caps, row_offset=b * m_block)
            votes = votes + ph.votes
            truncated |= ph.scan_overflow.to(torch.int32) * TRUNC_SCAN + ph.pair_overflow.to(torch.int32) * TRUNC_PAIRS
            bank_frame[:, s] = ph.sel_frame
            bank_verts[:, s] = sub.vertices[ph.sel_row.long()]
            if s + 1 < n:  # the last step's block would only travel home
                block = ppermute_next(block, mesh, "dp")

        cand_votes, cand_frames, cand_valid = select_candidates(votes, config.search)
        # The banked hits of all blocks, (B, D, n * U); their "rows" index
        # the flat bank, so verification gathers banked vertices.
        sel_frame_all = bank_frame.permute(0, 2, 1, 3).reshape(bsz, d_max, n * u)
        flat_ids = torch.arange(d_max * n * u, dtype=torch.int32, device=dev).reshape(1, d_max, n * u)
        pq, pslot, pv = extract_pairs(
            flat_ids.expand(bsz, -1, -1), sel_frame_all, cand_frames, cand_valid, caps.pairs_per_candidate, f_pad
        )
        verts_flat = bank_verts.permute(0, 2, 1, 3, 4, 5).reshape(bsz, d_max * n * u, 3, 3)
        ver = verify_pairs(batch_take(query.vertices, pq), batch_take(verts_flat, pslot), pv, cand_valid,
                           config.search)
        cand = CandidateSet(frames=cand_frames, votes=cand_votes, valid=cand_valid, pair_qidx=pq,
                            pair_row=pslot, pair_valid=pv, truncated=truncated)
        return rank_candidates(db_block, query, cand, ver, config)

    return localize_ring
