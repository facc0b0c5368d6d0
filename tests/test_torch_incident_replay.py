"""The port's incident drill on the CPU (``scripts/torch_incident_replay.py``,
after ``scripts/incident_replay.py``).

Both drills run on the CPU and return 0: a ``serve.step:6:corrupt`` fault
under 100% audit sampling is exactly one divergence, its flight dump
replays on a fresh port engine and bisects to chunk 6, the faulted re-run
reproduces the incident's digests, and the journal's analysis lands on the
same token and chunk.  A dump with nothing replayable exits 2.  A port
flight dump parses to the same incident under the JAX script's
``parse_incident`` (read only) as under the port's.  Tolerance: none.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import incident_replay  # noqa: E402
import torch_incident_replay as tir  # noqa: E402

from torchdistx_tpu_torch import telemetry  # noqa: E402
from torchdistx_tpu_torch.resilience import faults, preemption  # noqa: E402
from torchdistx_tpu_torch.serving import Engine  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    faults.reset("")
    yield
    preemption.clear()
    faults.reset("")


@pytest.mark.parametrize("which", ["drill", "journal_drill"])
def test_drills_pass_on_the_cpu(which, capsys):
    assert getattr(tir, which)(device="cpu") == 0
    assert "token 21 chunk 6" in capsys.readouterr().out


def test_nothing_replayable_exits_2(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert tir.main([str(empty), "--device", "cpu"]) == 2
    untraced = tmp_path / "untraced.jsonl"
    untraced.write_text("\n".join(json.dumps(r) for r in (
        {"type": "flight_dump", "reason": "stall", "attrs": {"engine": "eng9"}},
        {"type": "event", "name": "serve.engine_config", "engine": "eng9",
         "attrs": {"num_slots": 2}},
        {"type": "event", "name": "req.finished", "rid": "eng9-r0",
         "attrs": {"digest": "00"}})) + "\nnot json\n")
    assert tir.main([str(untraced), "--device", "cpu"]) == 2
    assert tir.main(["--journal", str(tmp_path), "--device", "cpu"]) == 2


def test_port_dump_parses_alike_under_both_scripts(tmp_path):
    """A port engine's flight dump (a fault fired, requests finished, one
    still queued, an audit replay marked) is the same incident to both
    scripts' ``parse_incident``."""
    flight = str(tmp_path / "flight.jsonl")
    prev = telemetry.configure(flight=flight, flight_capacity=4096)
    faults.reset("serve.step:2:nan")
    try:
        eng = Engine(tir.resolve_model("llama-test", "cpu"), device="cpu", audit_sample=1.0,
                     handle_preemption=False, **tir.DRILL_ENGINE)
        for i in range(3):
            eng.submit(np.arange(1 + i, 7 + i, dtype=np.int32), max_new_tokens=6, key=i)
        eng.drain()
        eng.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=4, key=9)
        assert telemetry.flight_dump("stall", engine=eng.engine_id) > 0
        eng.close()
    finally:
        faults.reset("")
        telemetry.configure(**prev)
    records = tir.load_dump(flight)
    assert records == incident_replay.load_dump(flight)
    port, ref = tir.parse_incident(records), incident_replay.parse_incident(records)
    assert port == ref
    assert len(port["requests"]) == 7 and port["dump_reasons"] == ["stall"]
    assert sum("audit_of" in r for r in port["requests"].values()) == 3
    assert port["faults_fired"] == [{"site": "serve.step", "step": 2, "kind": "nan"}]
    assert port["config"]["num_slots"] == tir.DRILL_ENGINE["num_slots"]
