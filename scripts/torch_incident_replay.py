#!/usr/bin/env python
"""Incident replay for the PyTorch port: turn a flight dump into a repro.

The counterpart of ``scripts/incident_replay.py`` for
``torchdistx_tpu_torch``'s serving engine; the same functions, the same
analysis and the same exit codes.  Every flight dump the port's ops plane
writes (``stall``, ``recompile_storm``, ``device_oom``, ``pool_exhausted``,
``slo_burn``, ``divergence``) carries the recent event window:
``req.submitted`` events with each traced request's replay identity
(prompt token ids and normalized sampling key), ``req.admitted`` order,
``req.finished`` with the determinism digest, the ``serve.engine_config``
geometry and ``fault.fired`` markers.  This tool:

1. **reconstructs** the request set and the engine geometry from the dump;
2. **re-runs** it on a fresh port ``Engine`` (weights from ``--model``, on
   ``--device``), one request at a time in admission order: a stream equals
   solo ``generate`` whatever the batch, so the sequential re-run is the
   ground truth for every request;
3. **bisects**: a request whose recorded digest differs from its re-run's
   is a reproduced divergence; where the dump holds the incident's stream
   (a ``reason="divergence"`` dump always does), the first diverging token
   maps to the chunk that committed it (``audit.token_chunk``);
4. with ``--with-faults``, re-arms the dump's ``fault.fired`` schedule and
   re-runs: the faulted re-run must reproduce the recorded digests.

Exit codes: ``0`` analysis completed (any recorded divergence reproduced
and bisected); ``1`` a recorded divergence this replay could not reproduce,
or a ``--with-faults`` reproduction failed; ``2`` nothing replayable.

``--journal DIR`` does the same over a request journal: a WAL self-check
(each entry's journaled digest against its journaled tokens), then a solo
re-run of every entry, bisecting any committed prefix that disagrees.

Usage::

    python scripts/torch_incident_replay.py /path/flight.jsonl [--device cpu]
    python scripts/torch_incident_replay.py flight.jsonl --with-faults --json out.json
    python scripts/torch_incident_replay.py --journal /path/journal-dir
    python scripts/torch_incident_replay.py --drill          # a corrupt fault at
        # decode chunk 6 under 100% audit sampling: exactly one divergence,
        # its dump replayed and bisected to chunk 6, the faulted re-run
        # reproducing the incident's digests
    python scripts/torch_incident_replay.py --journal-drill  # the same fault,
        # journaled: the journal analysis bisects the stream the auditor
        # flagged to the same token and chunk

``--model``: ``llama-test`` (the port's ``llama_test``, f32, from
``--seed``; built on the CPU and moved, so its weights are the same on
every device) or ``module.path:factory`` returning a port model.
``--device`` defaults to ``cuda`` and raises where CUDA is absent; pass
``--device cpu`` for the host.  Imports neither ``jax`` nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

__all__ = ["analyze", "analyze_journal", "drill", "journal_drill", "load_dump",
           "load_journal", "main", "parse_incident"]

# The drills' engine, requests and fault: JAX's drill, on the port.
DRILL_ENGINE = dict(num_slots=4, block_size=8, num_blocks=41, max_model_len=64,
                    decode_chunk=4, max_prefills_per_tick=4)
DRILL_STREAMS = 4
DRILL_PROMPT_LEN = 6
DRILL_BUDGET = 24
DRILL_FAULT_CHUNK = 6


# ---------------------------------------------------------------------------
# Dump parsing


def load_dump(path: str) -> List[Dict[str, Any]]:
    """All parsable JSONL records in the dump (bad lines skipped: a
    truncated tail must not void the post-mortem)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return records


def _attrs(rec: Dict[str, Any]) -> Dict[str, Any]:
    return rec.get("attrs") or {}


def parse_incident(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The incident's structure: requests (replay identity, recorded
    digests), engine config, fault schedule, divergence dumps."""
    requests: Dict[str, Dict[str, Any]] = {}
    config: Dict[str, Any] = {}
    faults_fired: List[Dict[str, Any]] = []
    divergence_dumps: List[Dict[str, Any]] = []
    dump_reasons: List[str] = []
    for rec in records:
        rtype = rec.get("type")
        if rtype == "flight_dump":
            dump_reasons.append(rec.get("reason"))
            if rec.get("reason") == "divergence":
                divergence_dumps.append(_attrs(rec))
            continue
        if rtype != "event":
            continue
        name = rec.get("name")
        attrs = _attrs(rec)
        if name == "serve.engine_config":
            config = dict(attrs)
            config["engine"] = rec.get("engine")
            continue
        if name == "fault.fired":
            faults_fired.append(dict(attrs))
            continue
        rid = rec.get("rid")
        if rid is None:
            continue
        req = requests.setdefault(rid, {"rid": rid})
        if name == "req.submitted":
            # A re-submission repeats req.submitted per hop with the same
            # identity: the first with a prompt wins.  Audit replays are
            # marked and left out of the re-run (the re-run IS the audit).
            if "prompt" in attrs and "prompt" not in req:
                req["prompt"] = attrs["prompt"]
                req["key"] = attrs.get("key")
                req["max_new"] = attrs.get("max_new")
                req["tenant"] = attrs.get("tenant", "default")
                req["priority"] = attrs.get("priority", 0)
            if attrs.get("audit_of") is not None:
                req["audit_of"] = attrs["audit_of"]
            req.setdefault("submitted_ts", rec.get("ts"))
        elif name == "req.admitted":
            req.setdefault("admitted_ts", rec.get("ts"))
        elif name == "req.finished":
            req["digest"] = attrs.get("digest")
            req["n_tokens"] = attrs.get("n_tokens")
        elif name == "req.failed":
            req["failed"] = attrs.get("error")
    return {
        "requests": requests,
        "config": config,
        "faults_fired": faults_fired,
        "divergence_dumps": divergence_dumps,
        "dump_reasons": dump_reasons,
    }


# ---------------------------------------------------------------------------
# Model and device


def _device(spec: str):
    """``spec`` as a torch device; ``cuda`` where CUDA is absent raises
    (the port never falls back to the CPU quietly)."""
    import torch

    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available on this host; "
                           "pass --device cpu to replay on the CPU")
    return device


def resolve_model(spec: str, device, seed: int = 0):
    """``llama-test`` or ``module.path:factory`` -> a port model on
    ``device``."""
    import torch

    if spec == "llama-test":
        from torchdistx_tpu_torch.models.llama import Llama, llama_test

        torch.manual_seed(seed)
        return Llama(llama_test(), device="cpu").to(device)
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise SystemExit(f"--model {spec!r}: expected 'llama-test' or 'module:factory'")
    import importlib

    return getattr(importlib.import_module(mod_name), fn_name)().to(device)


# ---------------------------------------------------------------------------
# The replay


def _build_engine(config: Dict[str, Any], model, device, **overrides):
    from torchdistx_tpu_torch.serving import Engine

    kw = dict(
        device=device,
        num_slots=config.get("num_slots", 4),
        block_size=config.get("block_size", 8),
        num_blocks=config.get("num_blocks"),
        max_model_len=config.get("max_model_len"),
        temperature=config.get("temperature", 0.0),
        top_k=config.get("top_k"),
        eos_id=config.get("eos_id"),
        decode_chunk=config.get("decode_chunk", 8),
        prefill_chunk=config.get("prefill_chunk", 512),
        max_prefills_per_tick=config.get("max_prefills_per_tick", 1),
        scheduler=config.get("scheduler", "fifo"),
        model_version=config.get("model_version", "v0"),
        handle_preemption=False,
    )
    kw.update(overrides)
    return Engine(model, **kw)


def analyze(
    records: List[Dict[str, Any]],
    *,
    model: str = "llama-test",
    device: str = "cuda",
    seed: int = 0,
    with_faults: bool = False,
    max_requests: Optional[int] = None,
) -> Dict[str, Any]:
    """Re-run a parsed dump on a fresh port engine and bisect any
    divergence (the drill and the tests call this)."""
    import numpy as np

    from torchdistx_tpu_torch.resilience import faults as faults_mod
    from torchdistx_tpu_torch.serving import RequestError
    from torchdistx_tpu_torch.telemetry import audit

    incident = parse_incident(records)
    config = incident["config"]
    decode_chunk = int(config.get("decode_chunk", 8) or 8)
    # The replayable set: traced user requests (not audit replays) that
    # carried a replay identity and were admitted, in admission order.
    replayable = sorted(
        (r for r in incident["requests"].values()
         if "prompt" in r and "audit_of" not in r and r.get("admitted_ts") is not None),
        key=lambda r: (r["admitted_ts"], r.get("submitted_ts") or 0),
    )
    if max_requests is not None:
        replayable = replayable[:max_requests]
    result: Dict[str, Any] = {
        "dump_reasons": incident["dump_reasons"],
        "n_requests_in_dump": len(incident["requests"]),
        "n_replayable": len(replayable),
        "engine_config": config,
        "faults_fired": incident["faults_fired"],
        "divergences": [],
        "reproduced": False,
    }
    if not replayable:
        result["error"] = ("nothing replayable: no traced request in the dump carries a "
                           "replay identity (prompt/key on req.submitted)")
        return result

    dev = _device(device)
    net = resolve_model(model, dev, seed)

    def run_all(engine):
        """Sequential ground truth: one request at a time, in admission
        order (a stream is batch-invariant, so this is an oracle for any
        original interleaving)."""
        out = {}
        for r in replayable:
            try:
                h = engine.submit(np.asarray(r["prompt"], np.int32),
                                  max_new_tokens=int(r["max_new"]),
                                  key=np.asarray(r["key"], np.uint32))
                toks = h.result()
            except (RequestError, ValueError) as err:
                out[r["rid"]] = {"error": f"{type(err).__name__}: {err}"}
                continue
            out[r["rid"]] = {"tokens": toks, "digest": h.digest}
        return out

    # Pass 1: clean ground truth (no faults, no auditor).
    eng = _build_engine(config, net, dev, audit_sample=0.0)
    try:
        truth = run_all(eng)
    finally:
        eng.close()

    # The incident's streams where the dump holds them (a divergence
    # dump's expected_tokens is the ORIGINAL stream).
    incident_streams = {d.get("rid"): d.get("expected_tokens")
                        for d in incident["divergence_dumps"] if d.get("rid") is not None}
    recorded_mismatch = False
    for r in replayable:
        rid = r["rid"]
        rerun = truth.get(rid, {})
        recorded_digest = r.get("digest")
        if recorded_digest is None or "digest" not in rerun:
            continue
        if rerun["digest"] == recorded_digest:
            continue
        recorded_mismatch = True
        row = {"rid": rid, "recorded_digest": recorded_digest,
               "rerun_digest": rerun["digest"]}
        stream = incident_streams.get(rid)
        if stream is not None:
            idx = audit.first_divergence(stream, rerun["tokens"])
            row["first_diverging_token"] = idx
            row["first_diverging_chunk"] = audit.token_chunk(idx, decode_chunk)
            row["incident_token"] = int(stream[idx]) if idx < len(stream) else None
            row["true_token"] = (int(rerun["tokens"][idx]) if idx < len(rerun["tokens"])
                                 else None)
        result["divergences"].append(row)

    # A divergence was RECORDED iff an auditor dumped one; the replay
    # reproduces it iff the clean re-run disagrees with the recorded
    # digests the same way.
    recorded_divergence = bool(incident["divergence_dumps"])
    result["recorded_divergence"] = recorded_divergence
    result["reproduced"] = recorded_mismatch if recorded_divergence else not recorded_mismatch

    # Pass 2 (opt-in): re-arm the fault schedule; the faulted engine must
    # reproduce the RECORDED digests.  Meaningful where fault step numbers
    # align (the drill's single engine).
    if with_faults and incident["faults_fired"]:
        spec = ",".join(f"{f['site']}:{f['step']}:{f['kind']}" for f in incident["faults_fired"]
                        if f.get("kind") not in ("crash", "sigterm", "fatal"))
        faults_mod.reset(spec or "")
        eng2 = _build_engine(config, net, dev, audit_sample=0.0)
        try:
            faulted = run_all(eng2)
        finally:
            eng2.close()
            faults_mod.reset("")
        repro = all(faulted.get(r["rid"], {}).get("digest") == r.get("digest")
                    for r in replayable if r.get("digest") is not None)
        result["faulted_rerun_matches_incident"] = repro
        if not repro:
            result["reproduced"] = False
    return result


# ---------------------------------------------------------------------------
# Journal forensics (--journal)


def load_journal(dirpath: str):
    """Fold a request-journal directory into ``(entries, config)``
    (torn tails tolerated, as recovery reads them)."""
    from torchdistx_tpu_torch.serving import journal as journal_mod

    entries, config = journal_mod.fold_records(list(journal_mod.read_records(dirpath)))
    return entries, (config or {})


def analyze_journal(
    dirpath: str,
    *,
    model: str = "llama-test",
    device: str = "cuda",
    seed: int = 0,
    max_requests: Optional[int] = None,
) -> Dict[str, Any]:
    """Hold a request journal to deterministic ground truth: each entry's
    journaled digest against its journaled tokens (WAL integrity, no model
    run), then a solo re-run that must reproduce its committed prefix, a
    mismatch bisected to its token and decode chunk."""
    import numpy as np

    from torchdistx_tpu_torch.serving import RequestError
    from torchdistx_tpu_torch.telemetry import audit

    entries, config = load_journal(dirpath)
    decode_chunk = int(config.get("decode_chunk", 8) or 8)
    todo = [entries[u] for u in sorted(entries)]
    if max_requests is not None:
        todo = todo[:max_requests]
    result: Dict[str, Any] = {
        "mode": "journal",
        "journal_dir": dirpath,
        "n_entries": len(entries),
        "n_unretired": sum(1 for e in entries.values() if not e.retired),
        "engine_config": config,
        "entries": [],
        "divergences": [],
        "digest_inconsistencies": [],
        "reproduced": False,
    }
    if not todo:
        result["error"] = f"nothing replayable: no journal entries in {dirpath}"
        return result

    dev = _device(device)
    eng = _build_engine(config, resolve_model(model, dev, seed), dev, audit_sample=0.0)
    try:
        for e in todo:
            row: Dict[str, Any] = {"uid": e.uid, "n_committed": len(e.tokens),
                                   "retired": e.retired, "outcome": e.outcome}
            committed = [int(t) for t in e.tokens]
            if e.digest is not None:
                dig = audit.DeterminismDigest.of_stream(
                    np.asarray(e.prompt, np.int32), np.asarray(e.key, np.uint32), committed,
                    e.model_version)
                row["digest_consistent"] = dig.hexdigest() == e.digest
                if not row["digest_consistent"]:
                    result["digest_inconsistencies"].append(dict(row))
            try:
                h = eng.submit(np.asarray(e.prompt, np.int32),
                               max_new_tokens=int(e.max_new_tokens),
                               key=np.asarray(e.key, np.uint32))
                toks = h.result()
            except (RequestError, ValueError) as err:
                row["error"] = f"{type(err).__name__}: {err}"
                result["entries"].append(row)
                continue
            row["n_rerun"] = len(toks)
            if toks[: len(committed)] != committed:
                idx = audit.first_divergence(committed, toks)
                row["first_diverging_token"] = idx
                row["first_diverging_chunk"] = audit.token_chunk(idx, decode_chunk)
                row["journaled_token"] = committed[idx] if idx < len(committed) else None
                row["true_token"] = int(toks[idx]) if idx < len(toks) else None
                result["divergences"].append(dict(row))
            result["entries"].append(row)
    finally:
        eng.close()
    result["reproduced"] = not result["divergences"] and not result["digest_inconsistencies"]
    return result


# ---------------------------------------------------------------------------
# The drills


def _drill_run(device: str, seed: int, **engine_kw):
    """The drill's incident: DRILL_STREAMS random prompts on one audited
    engine with a corrupt fault at decode chunk DRILL_FAULT_CHUNK.
    Returns the auditor's stats and its first divergence's detail."""
    import numpy as np

    from torchdistx_tpu_torch.resilience import faults as faults_mod
    from torchdistx_tpu_torch.serving import Engine

    dev = _device(device)
    net = resolve_model("llama-test", dev, seed)
    faults_mod.reset(f"serve.step:{DRILL_FAULT_CHUNK}:corrupt")
    rng = np.random.default_rng(7)
    try:
        eng = Engine(net, device=dev, handle_preemption=False, audit_sample=1.0,
                     **DRILL_ENGINE, **engine_kw)
        handles = [eng.submit(rng.integers(0, net.cfg.vocab_size, size=DRILL_PROMPT_LEN)
                              .astype(np.int32), max_new_tokens=DRILL_BUDGET, key=i)
                   for i in range(DRILL_STREAMS)]
        eng.drain()  # the user streams AND their shadow audits
        for h in handles:
            assert h.error is None, f"drill request failed: {h.error!r}"
        st = eng.stats()
        assert st["audit_checked"] >= DRILL_STREAMS, st
        assert st["audit_divergences"] == 1, (
            f"the auditor must flag EXACTLY the corrupted stream, got {st['audit_divergences']}")
        detail = eng._auditor.divergence_detail[0]
        assert detail["first_diverging_chunk"] == DRILL_FAULT_CHUNK, detail
        eng.close()
        return st, detail
    finally:
        faults_mod.reset("")


def journal_drill(device: str = "cuda", seed: int = 0) -> int:
    """A journaled run with the corrupt fault leaves a WAL whose
    ``--journal`` analysis finds exactly the corrupted stream, bisected to
    the token and chunk the live auditor flagged."""
    from torchdistx_tpu_torch.serving import RequestJournal

    jdir = os.path.join(tempfile.mkdtemp(prefix="tdx-torch-jdrill-"), "journal")
    _, detail = _drill_run(device, seed, journal=RequestJournal(jdir))
    result = analyze_journal(jdir, device=device, seed=seed)
    assert result["n_entries"] == DRILL_STREAMS, result
    assert not result["digest_inconsistencies"], (
        f"the WAL must be internally consistent (it recorded the corruption faithfully): {result}")
    assert len(result["divergences"]) == 1, result
    row = result["divergences"][0]
    assert row["first_diverging_token"] == detail["first_diverging_token"]
    assert row["first_diverging_chunk"] == detail["first_diverging_chunk"]
    print(f"torch_incident_replay journal drill OK on {device}: corrupt fault journaled, WAL "
          f"self-check passed on all {result['n_entries']} entries, analysis bisected entry "
          f"uid={row['uid']} to token {row['first_diverging_token']} chunk "
          f"{row['first_diverging_chunk']} (as the live auditor)")
    return 0


def drill(device: str = "cuda", seed: int = 0) -> int:
    """A corrupt fault under 100% audit sampling produces one
    ``reason="divergence"`` flight dump; replaying the dump bisects the
    divergence to the faulted chunk, and the faulted re-run reproduces the
    incident's digests."""
    from torchdistx_tpu_torch import telemetry

    flight_path = os.path.join(tempfile.mkdtemp(prefix="tdx-torch-incident-"), "flight.jsonl")
    prev = telemetry.configure(flight=flight_path, flight_capacity=8192)
    try:
        st, detail = _drill_run(device, seed)
        records = load_dump(flight_path)
        assert any(r.get("type") == "flight_dump" and r.get("reason") == "divergence"
                   for r in records), "no reason=divergence flight dump in the ring"
        result = analyze(records, device=device, seed=seed, with_faults=True)
        assert result["reproduced"], result
        assert result["faulted_rerun_matches_incident"], result
        assert len(result["divergences"]) == 1, result
        row = result["divergences"][0]
        assert row["rid"] == detail["rid"], (row, detail)
        # The auditor's bisection (incident against its shadow replay) and
        # the dump replay's (incident against a fresh ground truth) agree.
        assert row["first_diverging_token"] == detail["first_diverging_token"]
        assert row["first_diverging_chunk"] == detail["first_diverging_chunk"]
        print(f"torch_incident_replay drill OK on {device}: corrupt fault at decode chunk "
              f"{DRILL_FAULT_CHUNK} caught by the auditor (checked={st['audit_checked']}, "
              f"divergences=1), dump replayed, bisected to request {row['rid']} token "
              f"{row['first_diverging_token']} chunk {row['first_diverging_chunk']}, faulted "
              "re-run reproduced the incident digests")
        return 0
    finally:
        telemetry.configure(**prev)


# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dump", nargs="?", help="flight-dump JSONL to replay")
    ap.add_argument("--journal", metavar="DIR",
                    help="analyze a request-journal directory instead of a flight dump: WAL "
                    "self-check + solo re-run of every journaled stream")
    ap.add_argument("--model", default="llama-test",
                    help="weights: 'llama-test' or module.path:factory returning a port model")
    ap.add_argument("--seed", type=int, default=0, help="llama-test's weight seed")
    ap.add_argument("--device", default="cuda", help="where to replay (default cuda)")
    ap.add_argument("--with-faults", action="store_true",
                    help="also re-run with the dump's fault.fired schedule re-armed and "
                    "require the recorded digests to reproduce")
    ap.add_argument("--max-requests", type=int, default=None,
                    help="replay at most N requests (admission order)")
    ap.add_argument("--json", help="write the analysis JSON here")
    ap.add_argument("--drill", action="store_true",
                    help="run the self-contained corrupt-fault incident drill")
    ap.add_argument("--journal-drill", action="store_true",
                    help="run the self-contained journal forensics drill")
    args = ap.parse_args(argv)

    if args.drill:
        return drill(args.device, args.seed)
    if args.journal_drill:
        return journal_drill(args.device, args.seed)
    if not args.dump and not args.journal:
        ap.error("a dump path, --journal DIR, or --drill is required")

    if args.journal:
        result = analyze_journal(args.journal, model=args.model, device=args.device,
                                 seed=args.seed, max_requests=args.max_requests)
    else:
        records = load_dump(args.dump)
        if not records:
            print(f"torch_incident_replay: no parsable records in {args.dump}", file=sys.stderr)
            return 2
        result = analyze(records, model=args.model, device=args.device, seed=args.seed,
                         with_faults=args.with_faults, max_requests=args.max_requests)
    out = json.dumps(result, indent=2, sort_keys=True, default=str)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if result.get("error"):
        return 2
    return 0 if result["reproduced"] else 1


if __name__ == "__main__":
    sys.exit(main())
