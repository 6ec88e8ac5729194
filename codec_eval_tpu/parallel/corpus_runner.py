"""Corpus-scale sharded scoring: the end-to-end multi-chip path.

Takes an arbitrary list of decoded (reference, candidate) pairs, buckets
them by image shape (one compiled SPMD program per bucket — the mixed-size
strategy from SURVEY.md §5 "bucketed padding"), pads each bucket's batch up
to a multiple of the mesh's batch axis, and scores every bucket across the
device mesh with on-device aggregation.  This is the whole-corpus analog of
the reference's rayon fan-out (rd_calibrate.rs:184-216) with device collectives
in place of thread joins.

Staging and scoring are split (``stage_pairs_sharded`` / ``score_staged``)
so callers can overlap the host->device transfers of the next corpus slice
with the device scoring of the current one, and so benchmarks can report
device-only throughput separately from transfer-bound wall time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mesh import make_mesh, shard_batch, sharded_masked_score_fn, sharded_score_fn


@dataclass
class CorpusScores:
    """Per-pair scores (input order) + corpus means per metric."""

    per_pair: List[Dict[str, float]]
    means: Dict[str, float] = field(default_factory=dict)


@dataclass
class StagedPairs:
    """Device-resident bucketed corpus slice (see ``stage_pairs_sharded``).

    ``buckets`` holds, per padded shape: the original pair indices, the
    sharded device batches (refs, dists) and, on the masked path, the
    per-pair true (h, w) array.
    """

    n_pairs: int
    masked: bool
    wanted: frozenset
    step: object
    buckets: List[Tuple[List[int], object, object, Optional[np.ndarray]]]


def stage_pairs_sharded(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    mesh=None,
    dssim: bool = True,
    ssimulacra2: bool = True,
    butteraugli: bool = True,
    psnr: bool = True,
    masked: bool = False,
    granularity: int = 128,
) -> StagedPairs:
    """Bucket, pad and transfer (ref, dist) u8 pairs onto the mesh.

    Pads each bucket's batch by repeating its last pair up to a multiple of
    the mesh batch axis; padded entries are dropped from results and means.

    With ``masked=True``, pairs are bucketed by PADDED shape (multiples of
    ``granularity``) instead of exact shape and scored through the masked
    kernels (kernels/masked.py) — one compiled program per bucket covers
    every image size inside it, the right trade for corpora with many
    distinct sizes.  The masked path always computes all four metrics;
    the metric flags filter the returned dict.
    """
    if mesh is None:
        mesh = make_mesh(n_space=1)
    n_batch = mesh.devices.shape[0]

    wanted = frozenset(
        k
        for k, on in [
            ("dssim", dssim),
            ("ssimulacra2", ssimulacra2),
            ("butteraugli", butteraugli),
            ("psnr", psnr),
        ]
        if on
    )
    if masked:
        from ..kernels.masked import bucket_shapes, pad_to_bucket

        step = sharded_masked_score_fn(mesh)
        assignments = bucket_shapes([p[0].shape[:2] for p in pairs], granularity)
    else:
        step = sharded_score_fn(
            mesh, dssim=dssim, ssimulacra2=ssimulacra2,
            butteraugli=butteraugli, psnr=psnr,
        )
        assignments = [p[0].shape[:2] for p in pairs]

    # Bucket indices by (padded) shape.
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, (ref, dist) in enumerate(pairs):
        assert ref.shape == dist.shape, f"pair {i} shape mismatch"
        buckets.setdefault(assignments[i], []).append(i)

    staged: List[Tuple[List[int], object, object, Optional[np.ndarray]]] = []
    for shape, indices in buckets.items():
        if masked:
            refs = np.stack(
                [pad_to_bucket(pairs[i][0], *shape) for i in indices]
            )
            dists = np.stack(
                [pad_to_bucket(pairs[i][1], *shape) for i in indices]
            )
            hw = np.array([pairs[i][0].shape[:2] for i in indices], np.int32)
        else:
            refs = np.stack([pairs[i][0] for i in indices])
            dists = np.stack([pairs[i][1] for i in indices])
            hw = None
        n = len(indices)
        padded = ((n + n_batch - 1) // n_batch) * n_batch
        if padded != n:
            refs = np.concatenate([refs, np.repeat(refs[-1:], padded - n, 0)])
            dists = np.concatenate([dists, np.repeat(dists[-1:], padded - n, 0)])
            if masked:
                hw = np.concatenate([hw, np.repeat(hw[-1:], padded - n, 0)])
        staged.append(
            (indices, shard_batch(mesh, refs), shard_batch(mesh, dists), hw)
        )
    return StagedPairs(
        n_pairs=len(pairs), masked=masked, wanted=wanted, step=step,
        buckets=staged,
    )


def score_staged(staged: StagedPairs) -> CorpusScores:
    """Score a staged corpus slice: device dispatches + result fetch only."""
    per_pair: List[Optional[Dict[str, float]]] = [None] * staged.n_pairs
    for indices, refs, dists, hw in staged.buckets:
        if staged.masked:
            scores, _ = staged.step(refs, dists, hw)
        else:
            scores, _ = staged.step(refs, dists)
        scores = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in scores.items()
            if k in staged.wanted
        }
        for j, i in enumerate(indices):
            per_pair[i] = {k: float(scores[k][j]) for k in scores}

    result = CorpusScores(per_pair=[p for p in per_pair if p is not None])
    if result.per_pair:
        keys = result.per_pair[0].keys()
        result.means = {
            k: float(np.mean([p[k] for p in result.per_pair])) for k in keys
        }
    return result


def score_pairs_sharded(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    mesh=None,
    dssim: bool = True,
    ssimulacra2: bool = True,
    butteraugli: bool = True,
    psnr: bool = True,
    masked: bool = False,
    granularity: int = 128,
) -> CorpusScores:
    """Stage + score in one call (see ``stage_pairs_sharded``)."""
    return score_staged(
        stage_pairs_sharded(
            pairs, mesh=mesh, dssim=dssim, ssimulacra2=ssimulacra2,
            butteraugli=butteraugli, psnr=psnr, masked=masked,
            granularity=granularity,
        )
    )


__all__ = [
    "CorpusScores",
    "StagedPairs",
    "score_pairs_sharded",
    "score_staged",
    "stage_pairs_sharded",
]
