"""Multi-device localization: DB rows sharded, queries data-parallel (port
of sgtd_tpu.parallel.sharded_match).

The descriptor table shards across the ``db`` dim of the mesh and the
query scans across ``dp``. Each rank, for its queries:

  bucket probes + rough filter on its rows        (local rows only)
  -> psum of the vote tallies over ``db``         (exact global votes)
  -> the same top-K candidates on every rank of the ``db`` group
  -> local pair extraction (a quota of pairs_per_candidate / n_db pairs)
     and vertex gathers
  -> all_gather of the pair lists over ``db``     (small: C x P x 3 x 3)
  -> the same batched verification on every rank of the ``db`` group.

The map-sized work (bucket scans, votes) is split over the shards; only
candidate pair lists cross between ranks. The result equals the
single-device pipeline's up to the per-shard split of the pair quota.
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
from sgtd_tpu_torch.parallel.mesh import all_gather, axis_size, pmax, psum
from sgtd_tpu_torch.utils import batch_take, disable_tf32


def _compact_valid_first(pair_valid: torch.Tensor, *arrays: torch.Tensor):
    """Reorder each candidate's gathered pairs so the valid ones form a
    prefix, in their order (``verify_pairs`` samples its hypotheses by
    position): a stable sort of ``~pair_valid`` along the pair axis.
    pair_valid (..., P); each array (..., P, *rest)."""
    order = torch.sort((~pair_valid).to(torch.uint8), dim=-1, stable=True).indices
    out = [torch.gather(pair_valid, -1, order)]
    k = order.dim()
    for a in arrays:
        idx = order.reshape(order.shape + (1,) * (a.dim() - k)).expand(order.shape + a.shape[k:])
        out.append(torch.gather(a, k - 1, idx))
    return out


def make_sharded_localizer(mesh, config: SGTDConfig = SGTDConfig()):
    """A callable ``(db_local, row_offset, graphs_local) ->
    LocalizationResult`` for this rank: ``db_local`` and ``row_offset`` as
    :func:`sgtd_tpu_torch.parallel.mesh.shard_database` gives them,
    ``graphs_local`` this rank's slice of the query batch along ``dp``.
    Every rank of a ``db`` group calls it on the same queries, the same
    number of times. The result holds this rank's queries."""
    n_db = axis_size(mesh, "db")
    p_local = max(config.caps.pairs_per_candidate // n_db, 1)

    def localize_sharded(db_local: DescriptorDB, row_offset: int, graphs_local: SemanticGraph) -> LocalizationResult:
        disable_tf32()
        query = build_descriptors(graphs_local, config.desc, config.caps)
        ph = probe_and_hits(db_local, query, config.desc, config.search, config.caps, row_offset=row_offset)
        # Float32 counts of whole votes below 2^24: exact in any order.
        votes = psum(ph.votes, mesh, "db")
        truncated = pmax(
            ph.scan_overflow.to(torch.int32) * TRUNC_SCAN + ph.pair_overflow.to(torch.int32) * TRUNC_PAIRS,
            mesh, "db",
        )
        cand_votes, cand_frames, cand_valid = select_candidates(votes, config.search)
        pq, pr, pv = extract_pairs(
            ph.sel_row, ph.sel_frame, cand_frames, cand_valid, p_local, db_local.frame_poses.shape[0]
        )
        # Pair rows are shard-local: gather the vertex triples here, then
        # concatenate the shards' pair lists.
        vq = all_gather(batch_take(query.vertices, pq), mesh, "db", dim=2)  # (B, C, n_db * Pl, 3, 3)
        vdb = all_gather(db_local.vertices[pr.long()], mesh, "db", dim=2)
        pv = all_gather(pv, mesh, "db", dim=2)
        pv, vq, vdb = _compact_valid_first(pv, vq, vdb)
        ver = verify_pairs(vq, vdb, pv, cand_valid, config.search)
        cand = CandidateSet(frames=cand_frames, votes=cand_votes, valid=cand_valid, pair_qidx=None,
                            pair_row=None, pair_valid=pv, truncated=truncated)
        return rank_candidates(db_local, query, cand, ver, config)

    return localize_sharded
