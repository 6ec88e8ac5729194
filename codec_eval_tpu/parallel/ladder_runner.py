"""Corpus-scale device-resident tpujpeg ladders over the mesh.

The multi-chip form of engine/tpu_sweep.py: a batch of same-size images is
sharded over the mesh's batch axis; each device encodes, decodes, and
scores its images' full quality ladders locally (shard_map — per-shard
shapes equal the single-image path, so every kernel runs unchanged),
and only quantized coefficients return to the host, where the native
Huffman coder produces exact byte sizes.

This is the accelerator replacement for the reference's calibration
pipeline hot path — rayon threads fanning mozjpeg encodes + CPU metric
kernels over a corpus (reference: crates/codec-compare/src/rd_calibrate.rs:
184-216) — with the whole encode/decode/score inner loop on the
accelerator and device collectives in place of thread joins for the corpus
means.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .mesh import make_mesh

__all__ = ["CorpusLadders", "sweep_corpus_ladders"]


@dataclass
class CorpusLadders:
    """Ladder scores/sizes for N images x n_q qualities (input order)."""

    qualities: List[float]
    scores: Dict[str, np.ndarray]  # metric -> (N, n_q)
    sizes: Optional[np.ndarray]  # (N, n_q) int64 bytes, or None
    bits_per_pixel: Optional[np.ndarray]  # (N, n_q), or None

    def mean_curve(self, metric: str) -> List[tuple]:
        """Corpus-mean (bpp, score) curve per quality — the rd-calibrate
        aggregation (reference: rd_calibrate.rs:240-260)."""
        if self.bits_per_pixel is None:
            raise ValueError("sizes were not computed (with_sizes=False)")
        m = self.scores[metric]
        return [
            (float(self.bits_per_pixel[:, qi].mean()), float(m[:, qi].mean()))
            for qi in range(m.shape[1])
        ]


def sweep_corpus_ladders(
    images: Sequence[np.ndarray],
    qualities: Sequence[float],
    mesh=None,
    subsampling: str = "420",
    aq_strength: float = 0.30,
    metrics: Sequence[str] = ("dssim", "ssimulacra2", "butteraugli", "psnr"),
    with_sizes: "bool | str" = True,
    images_per_chunk: int = 8,
    trellis_lambda: float = 0.0,
    multihost: bool = False,
) -> CorpusLadders:
    """Evaluate tpujpeg quality ladders for a same-size image corpus.

    Images are processed in chunks of ``images_per_chunk`` (padded by
    repeating the last image up to a batch-axis multiple; padding rows are
    dropped from the result), so coefficient memory stays bounded while the
    device pipeline stays busy.

    with_sizes="device" computes byte sizes from device-side rate
    statistics (kernels/jpeg_rate.py): each device reduces its ladders to
    (2x16 + 2x256) symbol counts per quality inside the SPMD step, so no
    coefficient planes cross the host boundary at all — entropy-exact
    sizes, 0xFF stuffing estimated (~±0.15%).  True entropy-codes fetched
    coefficients on host for exact bytes.

    ``multihost=True`` runs the SAME SPMD step over a multi-process global
    mesh (jax.distributed must be initialized and ``mesh`` span all
    processes' devices): every process passes the identical full ``images``
    list, ships only its contiguous per-process slice of each chunk
    (``host_local_batch_to_global``), and the step all-gathers results over
    the batch axis so every host returns the complete CorpusLadders.
    Requires ``with_sizes`` in {False, "device"} (exact host entropy coding
    would duplicate per-host work; use the device rate statistics).
    """
    import jax
    import jax.numpy as jnp
    try:
        from jax import shard_map as _shard_map  # jax >= 0.8

        def shard_map(f, **kw):  # check_rep was renamed check_vma
            kw["check_vma"] = kw.pop("check_rep", True)
            return _shard_map(f, **kw)

    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..engine.scoring import (
        _build_chunk_scorer,
        _build_precompute,
        fetch_scores as _fetch_scores,
    )
    from ..engine.tpu_sweep import _qtabs_for
    from ..kernels import jpeg_enc as _je
    from ..kernels import jpeg_rate as _jr
    from ..utils import native as _native

    size_mode = {True: "exact", False: "none"}.get(with_sizes, with_sizes)
    if size_mode not in ("exact", "none", "device"):
        raise ValueError(f"with_sizes must be bool or 'device', got {with_sizes!r}")
    if multihost and size_mode == "exact":
        raise ValueError(
            "multihost ladders need with_sizes=False or 'device' "
            "(host entropy coding would run once per process)"
        )
    with_sizes = size_mode != "none"

    if mesh is None:
        mesh = make_mesh(n_space=1)
    n_batch = int(mesh.devices.shape[0])
    if not images:
        raise ValueError("no images")
    h, w = images[0].shape[:2]
    for im in images:
        if im.shape[:2] != (h, w):
            raise ValueError("sweep_corpus_ladders requires same-size images")
    n_q = len(qualities)
    want = {m: m in metrics for m in ("dssim", "ssimulacra2", "butteraugli", "psnr")}

    recon = _je.build_reconstruct_sweep(
        h, w, n_q, subsampling,
        planar_candidates=True, with_coefs=with_sizes,
        trellis_lambda=float(trellis_lambda),
    )
    # Packed-histogram layout and unpacking live in jpeg_rate; reusing its
    # ladder builder keeps this runner in lockstep with
    # size_estimates_from_packed.
    rate_stats = (
        _jr.build_ladder_rate_stats(subsampling) if size_mode == "device" else None
    )
    pre_fn = _build_precompute(
        h, w, want["dssim"], want["ssimulacra2"], want["butteraugli"], False
    )
    # Score-chunk the quality axis for large images: the all-metric scorer's
    # temporaries scale with (candidates x pixels).  21 Mpix of candidates
    # per scoring sub-call scores a 512px ladder of up to 80 qualities in
    # one sub-call and gives 2048px sub-calls of 5 candidates, below the
    # 8-candidate 2048px chunk program that chip_smoke.py runs on the GPU
    # (device memory per candidate pixel on an H100 is in PERF.md).
    import os as _os

    budget_px = int(_os.environ.get("CODEC_EVAL_LADDER_SCORE_PX", "21000000"))
    q_chunk = max(1, min(n_q, budget_px // (h * w)))
    scorer = _build_chunk_scorer(
        h, w, q_chunk,
        want["dssim"], want["ssimulacra2"], want["butteraugli"], want["psnr"],
        planar=True,
    )
    q_tail = n_q % q_chunk
    scorer_tail = (
        _build_chunk_scorer(
            h, w, q_tail,
            want["dssim"], want["ssimulacra2"], want["butteraugli"],
            want["psnr"], planar=True,
        )
        if q_tail and q_chunk < n_q
        else None
    )

    def score_ladder(pre, cands):
        if q_chunk >= n_q:
            return scorer(pre, cands)
        parts = []
        for qs in range(0, n_q - q_tail, q_chunk):
            parts.append(scorer(pre, cands[qs : qs + q_chunk]))
        if scorer_tail is not None:
            parts.append(scorer_tail(pre, cands[n_q - q_tail :]))
        return jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *parts
        )
    qtabs = jnp.asarray(_qtabs_for(qualities))
    aq = jnp.float32(aq_strength)

    # Per-chunk SPMD step: each device loops its local images with the
    # exact single-image programs (no extra batch rank on the kernels).
    # The local unroll scales DOWN with image area — XLA overlaps the
    # unrolled iterations and their live sets add up, so the default of 8
    # is sized for 512px images.  It never
    # scales up: each extra unrolled image retraces the whole pipeline,
    # so small images would pay compile time for no throughput.
    if h * w > 512 * 512:
        images_per_chunk = max(1, images_per_chunk * (512 * 512) // (h * w))
    chunk_n = max(images_per_chunk, n_batch)
    chunk_n = ((chunk_n + n_batch - 1) // n_batch) * n_batch
    n_local = chunk_n // n_batch

    def local_ladders(imgs_local):
        score_rows = []
        coef_rows = []
        for i in range(n_local):
            img = imgs_local[i]
            cands, coefs = recon(img, qtabs, aq)
            score_rows.append(score_ladder(pre_fn(img), cands))
            if rate_stats is not None:
                # Reduce ladders to packed symbol histograms on device;
                # the coefficient planes never leave the shard.
                coefs = rate_stats(coefs["y"], coefs["cb"], coefs["cr"])
            coef_rows.append(coefs)
        scores = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *score_rows
        )
        coefs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *coef_rows)
        if multihost:
            # All-gather over the mesh so every process can read the full
            # chunk results (each process's devices then hold replicas).
            gather = lambda x: jax.lax.all_gather(x, "batch", axis=0, tiled=True)
            scores = jax.tree_util.tree_map(gather, scores)
            coefs = jax.tree_util.tree_map(gather, coefs)
        return scores, coefs

    spec_in = P("batch", None, None, None)
    spec_out = P(None) if multihost else P("batch")
    step = jax.jit(
        shard_map(
            local_ladders,
            mesh=mesh,
            in_specs=(spec_in,),
            out_specs=(spec_out, spec_out),
            check_rep=False,
        )
    )

    n = len(images)
    all_scores: Dict[str, List[np.ndarray]] = {}
    sizes = np.zeros((n, n_q), dtype=np.int64) if with_sizes else None
    qt_zz = [
        tuple(t[_je.ZIGZAG] for t in _je.quality_to_qtables(q)) for q in qualities
    ]

    def _encode_chunk_sizes(cy, ccb, ccr, start, real):
        for ii in range(real):
            for qi in range(n_q):
                ql, qc = qt_zz[qi]
                data = _native.jpeg_encode_baseline(
                    w, h, subsampling,
                    cy[ii, qi], ccb[ii, qi], ccr[ii, qi], ql, qc,
                )
                sizes[start + ii, qi] = len(data)

    # Exact sizes: one worker thread entropy-codes chunk k while chunk k+1
    # runs on device — the serial host pass otherwise idles the device for
    # most of the wall time (tpu_sweep's single-image path does the same).
    with ThreadPoolExecutor(max_workers=1) as size_pool:
        pending = None
        for start in range(0, n, chunk_n):
            chunk = list(images[start : start + chunk_n])
            real = len(chunk)
            while len(chunk) < chunk_n:
                chunk.append(chunk[-1])
            stacked = np.stack(chunk)
            if multihost:
                from .multihost import host_local_batch_to_global

                # Every process sees the same `images`; ship only this
                # process's contiguous slice of the chunk's batch axis.
                per = chunk_n // jax.process_count()
                pid = jax.process_index()
                staged = host_local_batch_to_global(
                    mesh, stacked[pid * per : (pid + 1) * per]
                )
            else:
                staged = jnp.asarray(stacked)
            scores, coefs = step(staged)
            host_scores = _fetch_scores(scores)
            for k, v in host_scores.items():
                all_scores.setdefault(k, []).append(v[:real])
            if size_mode == "device":
                st = np.asarray(coefs)  # (chunk_n, n_q, 544) in one fetch
                for ii in range(real):
                    sizes[start + ii] = _jr.size_estimates_from_packed(st[ii])
            elif with_sizes:
                cy, ccb, ccr = jax.device_get(
                    (coefs["y"], coefs["cb"], coefs["cr"])
                )
                if pending is not None:
                    pending.result()
                pending = size_pool.submit(
                    _encode_chunk_sizes, cy, ccb, ccr, start, real
                )
        if pending is not None:
            pending.result()

    return CorpusLadders(
        qualities=[float(q) for q in qualities],
        scores={k: np.concatenate(v) for k, v in all_scores.items()},
        sizes=sizes,
        bits_per_pixel=(sizes * 8.0 / (h * w)) if with_sizes else None,
    )
