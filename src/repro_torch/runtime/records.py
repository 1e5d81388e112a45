"""JSONL persistence for execution records.

Execute-time records are the same RunRecord shape characterisation
consumes (paper §2, Fig. 1), which makes a recorded run *replayable*: dump
an online run's records (``RuntimeReport.records`` /
``OnlineReport.records`` / ``Scheduler.characterise_records``) to JSONL,
load them back offline, and re-fit models or re-score allocations without
touching a platform.

One JSON object per line, ``{"kind": <record class name>, ...fields}``.
Known record kinds resolve lazily (loading pricing records must not import
the LM model zoo and vice versa); third-party domains register theirs with
:func:`register_record_type`. Floats survive the round trip exactly —
``json`` emits shortest-repr floats — so loaded records compare equal to
the originals, which the replay tests rely on.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import warnings
from typing import Any, Iterable, Sequence

__all__ = ["dump_records", "load_records", "group_records",
           "register_record_type"]

#: kind -> "module.path:ClassName" for the record types shipped in-repo.
_BUILTIN: dict[str, str] = {
    "RunRecord": "repro_torch.pricing.platforms:RunRecord",
    # fault-layer audit trails: a run's fault history persists next to
    # its execution records
    "FaultEvent": "repro_torch.runtime.faults:FaultEvent",
    "DegradationEvent": "repro_torch.runtime.faults:DegradationEvent",
    "BreakerTransition": "repro_torch.runtime.faults:BreakerTransition",
    # overload-control audit trails (shedding / brownout guardrail)
    "ShedEvent": "repro_torch.runtime.admission:ShedEvent",
    "BrownoutTransition": "repro_torch.runtime.admission:BrownoutTransition",
    # observability: metric snapshots and prediction-ledger entries
    # persist on the same stream as the run they describe
    "MetricSnapshot": "repro_torch.obs.metrics:MetricSnapshot",
    "LedgerEntry": "repro_torch.obs.ledger:LedgerEntry",
}

#: kinds the reference package ships whose classes this package does not
#: have yet, with the part of the port that will bring them
_NOT_YET_PORTED: dict[str, str] = {
    "ServeRecord": "the LM-serving slice (repro_torch.domains.lm_serving)",
}

_REGISTRY: dict[str, type] = {}


def register_record_type(cls: type, name: str | None = None) -> None:
    """Register a record dataclass so :func:`load_records` can revive it."""
    _REGISTRY[name or cls.__name__] = cls


def _resolve(kind: str) -> type:
    if kind in _REGISTRY:
        return _REGISTRY[kind]
    path = _BUILTIN.get(kind)
    if path is None and kind in _NOT_YET_PORTED:
        raise KeyError(
            f"record kind {kind!r} is not ported yet: it waits for "
            f"{_NOT_YET_PORTED[kind]}")
    if path is None:
        raise KeyError(
            f"unknown record kind {kind!r}; register it with "
            f"register_record_type")
    mod_name, _, attr = path.partition(":")
    cls = getattr(importlib.import_module(mod_name), attr)
    _REGISTRY[kind] = cls
    return cls


def dump_records(records: Iterable[Any], path: str | os.PathLike) -> int:
    """Write records to ``path`` as JSONL; returns the number written."""
    n = 0
    with open(path, "w") as fh:
        for rec in records:
            if not dataclasses.is_dataclass(rec):
                raise TypeError(
                    f"records must be dataclasses, got {type(rec).__name__}")
            fields = dataclasses.asdict(rec)
            if "kind" in fields:
                # the envelope key is reserved for the class name; a field
                # named "kind" would silently shadow it and break load
                raise TypeError(
                    f"{type(rec).__name__} has a field named 'kind', which "
                    f"the JSONL envelope reserves for the record class")
            row = {"kind": type(rec).__name__, **fields}
            fh.write(json.dumps(row) + "\n")
            n += 1
    return n


def load_records(path: str | os.PathLike) -> list[Any]:
    """Load a JSONL record dump back into typed record objects.

    A truncated *final* line — the signature of a crash or overload kill
    mid-``dump_records`` — is tolerated: the intact prefix is returned
    with a :class:`UserWarning` so post-crash replay always works.
    Malformed lines anywhere else still raise, because those indicate
    corruption rather than a torn tail.
    """
    with open(path) as fh:
        lines = fh.readlines()
    last = len(lines) - 1
    while last >= 0 and not lines[last].strip():
        last -= 1
    out: list[Any] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            if i == last:
                warnings.warn(
                    f"{os.fspath(path)}: discarding truncated final JSONL "
                    f"line ({len(line)} bytes); returning the "
                    f"{len(out)}-record intact prefix", stacklevel=2)
                break
            raise
        cls = _resolve(row.pop("kind"))
        out.append(cls(**row))
    return out


def group_records(records: Sequence[Any]) -> dict[tuple[str, int], list[Any]]:
    """Group a flat record list per (platform, task_id) — the window shape
    ``Scheduler.refit`` and ``Domain.fit_models`` consume when replaying a
    dumped run offline."""
    out: dict[tuple[str, int], list[Any]] = {}
    for rec in records:
        out.setdefault((rec.platform, rec.task_id), []).append(rec)
    return out
