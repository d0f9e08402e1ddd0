"""Resilience-annotation checks (``STG4xx``) over Chakra traces.

``export_ranks(..., resilience_events=...)`` stamps failure/restore
epoch markers (``attrs.phase == "resilience"``) into every stage body.
These passes verify the invariants a downtime-aware feeder relies on:

* **STG401** — epochs are numbered ``0..n-1`` in node order, kinds
  alternate ``failure`` -> ``restore``, and wall-clock times are
  monotone (a restore never precedes its failure, the next failure
  never precedes the previous restore).
* **STG402** — every failure has its restore (and vice versa): markers
  come in complete pairs sharing an epoch.
* **STG403** — the export manifest's ``resilience.events`` count agrees
  with the pairs actually stamped in each rank body.
* **STG404** — ``ckpt_step`` (the checkpoint a restore rewinds to)
  never regresses across epochs: committed checkpoints are monotone.

Pure traversals, reported through the shared diagnostics framework like
every other pass family.
"""
from __future__ import annotations

from .diagnostics import (RESILIENCE_CKPT_REGRESSION, RESILIENCE_EPOCH_ORDER,
                          RESILIENCE_MANIFEST, RESILIENCE_UNMATCHED, Report)

__all__ = ["resilience_markers", "check_resilience_nodes",
           "check_resilience_manifest"]


def resilience_markers(nodes: list) -> list[dict]:
    """The resilience epoch markers of one trace body, in node order."""
    return [nd for nd in nodes
            if isinstance(nd, dict)
            and nd.get("attrs", {}).get("phase") == "resilience"]


def check_resilience_nodes(nodes: list, rank, rep: Report) -> None:
    """Per-rank STG401/402/404 checks (no-op without markers)."""
    marks = resilience_markers(nodes)
    if not marks:
        return
    pairs: dict[int, dict[str, dict]] = {}
    prev_kind = None
    prev_t = None
    prev_epoch = -1
    for nd in marks:
        at = nd.get("attrs", {})
        kind = at.get("kind")
        epoch = at.get("epoch")
        t = at.get("t")
        if kind not in ("failure", "restore") or not isinstance(epoch, int):
            rep.add(RESILIENCE_EPOCH_ORDER,
                    f"marker {nd.get('name')!r} has kind={kind!r} "
                    f"epoch={epoch!r} (need failure|restore + int epoch)",
                    node=nd.get("id"), rank=rank)
            continue
        expect = "failure" if prev_kind in (None, "restore") else "restore"
        if kind != expect:
            rep.add(RESILIENCE_EPOCH_ORDER,
                    f"epoch {epoch}: {kind} marker where {expect} expected "
                    f"(markers must alternate failure -> restore)",
                    node=nd.get("id"), rank=rank)
        want = prev_epoch + 1 if kind == "failure" else prev_epoch
        if epoch != want:
            rep.add(RESILIENCE_EPOCH_ORDER,
                    f"{kind} marker numbered epoch {epoch}, expected {want}",
                    node=nd.get("id"), rank=rank)
        if isinstance(t, (int, float)):
            if prev_t is not None and t < prev_t:
                rep.add(RESILIENCE_EPOCH_ORDER,
                        f"epoch {epoch} {kind} at t={t} precedes the "
                        f"previous marker at t={prev_t}",
                        node=nd.get("id"), rank=rank)
            prev_t = t
        prev_kind = kind
        prev_epoch = epoch
        pairs.setdefault(epoch, {})[kind] = nd

    for epoch in sorted(pairs):
        have = pairs[epoch]
        for kind in ("failure", "restore"):
            if kind not in have:
                other = "restore" if kind == "failure" else "failure"
                nd = have[other]
                rep.add(RESILIENCE_UNMATCHED,
                        f"epoch {epoch} has a {other} marker but no {kind}",
                        node=nd.get("id"), rank=rank,
                        fixit="export resilience events as complete "
                              "(failure, restore) pairs")

    last_ckpt = None
    for epoch in sorted(pairs):
        nd = pairs[epoch].get("restore") or pairs[epoch].get("failure")
        ck = nd.get("attrs", {}).get("ckpt_step")
        if not isinstance(ck, int):
            continue
        if last_ckpt is not None and ck < last_ckpt:
            rep.add(RESILIENCE_CKPT_REGRESSION,
                    f"epoch {epoch} rewinds to ckpt_step {ck} after a "
                    f"prior epoch already restored from {last_ckpt}",
                    node=nd.get("id"), rank=rank,
                    fixit="a restore must never rewind past a checkpoint "
                          "a later epoch already committed")
        else:
            last_ckpt = ck


def check_resilience_manifest(manifest, traces: dict, rep: Report) -> None:
    """Dir-level STG403: the manifest's recorded incident count must
    match the pairs stamped in every rank body (the manifest is written
    once; the bodies are per stage — disagreement means the export was
    assembled from mixed runs)."""
    meta = (manifest or {}).get("resilience")
    declared = meta.get("events") if isinstance(meta, dict) else None
    for rank, tr in traces.items():
        marks = resilience_markers(tr.get("nodes") or [])
        stamped = len({nd["attrs"].get("epoch") for nd in marks})
        if declared is None:
            if marks:
                rep.add(RESILIENCE_MANIFEST,
                        f"{stamped} resilience epoch(s) stamped but the "
                        f"manifest declares none",
                        rank=rank,
                        fixit="re-export with export_ranks(resilience_"
                              "events=...) so the manifest records them")
            continue
        if stamped != declared:
            rep.add(RESILIENCE_MANIFEST,
                    f"manifest declares {declared} resilience event(s) "
                    f"but the rank body stamps {stamped}",
                    rank=rank)
