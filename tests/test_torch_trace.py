"""The port's collective tracer against the JAX package's.

``horovod_tpu_torch/trace`` is a copy of ``horovod_tpu/trace``; what the
port changes is where the engine stamps.  Here the same stamp streams,
made from a numpy seed, go into both recorders: complete spans, partial
ones (aborted after some phase, as an abort or a negotiation error leaves
them), two-level spans carrying a modelled cross-link share
(``cross_frac``), still-open spans and cycle records.  Both must give equal
``phase_summary()``, ``digest()`` and ``phase_histograms()``, byte-equal
writer files, equal merged perfetto JSON and equal critical-path reports,
and the two CLIs the same report.  The port's ``HOROVOD_TRACE`` parsing is
the JAX package's (``tests/test_trace.py`` ``test_trace_env_parsing``).
"""

import json
import logging
import time

import numpy as np
import pytest

from horovod_tpu import trace as jtrace
from horovod_tpu.trace import analyze as janalyze
from horovod_tpu.trace import merge as jmerge
from horovod_tpu_torch import trace as ptrace
from horovod_tpu_torch.trace import analyze as panalyze
from horovod_tpu_torch.trace import merge as pmerge

# case -> (spans, share of partial spans, share of two-level spans, open)
CASES = {
    "flat": (40, 0.0, 0.0, 0),
    "partial": (40, 0.4, 0.0, 3),
    "two_level": (40, 0.0, 0.7, 0),
    "mixed": (120, 0.25, 0.3, 5),
}


def _stream(seed, n, partial, hier, n_open):
    """A stamp stream: cycle records, then per span (name, cycle, slot,
    stamps, error, cross_frac, how many stamps landed), then open spans.
    Stamps are monotonic seconds; a partial span stops after 1-4 of its
    five phases."""
    rng = np.random.RandomState(seed)
    cycles, spans = [], []
    t = 1000.0
    n_cycles = max(1, n // 8)
    for c in range(n_cycles):
        t0 = t + float(rng.uniform(0, 0.01))
        cycles.append((c + 1, t0, t0 + 1e-4, t0 + 2e-4, t0 + 3e-4,
                       int(rng.randint(1, 9)), float(rng.uniform(0, 500))))
        t = t0 + 0.02
    for i in range(n):
        t0 = 1000.0 + float(rng.uniform(0, 0.02 * n_cycles))
        durs = rng.exponential(1e-3, size=5)
        stamps = [t0]
        for d in durs:
            stamps.append(stamps[-1] + float(d))
        landed = 5
        if rng.uniform() < partial:
            landed = int(rng.randint(1, 5))
        frac = float(rng.uniform(0.05, 0.95)) if rng.uniform() < hier else 0.0
        spans.append((f"grad.{i % 17}", int(rng.randint(1, n_cycles + 1)),
                      int(rng.randint(-1, 40)), stamps, landed < 5, frac,
                      landed))
    opens = [(f"open.{i}", 2000.0 + i, 2000.0 + i + 1e-3)
             for i in range(n_open)]
    return cycles, spans, opens


def _feed(rec, stream):
    cycles, spans, opens = stream
    for c in cycles:
        rec.cycle(*c)
    for name, cyc, slot, st, err, frac, landed in spans:
        sp = rec.begin(name, st[0], st[1])
        sp.cycle, sp.slot, sp.cross_frac = cyc, slot, frac
        for attr, t in zip(("t_ready", "t_launch", "t_result", "t_done"),
                           st[2:2 + landed - 1]):
            setattr(sp, attr, t)
        sp.error = err
        rec.commit(sp)
    for name, te, td in opens:
        rec.begin(name, te, td)
    return rec


def _recorders(monkeypatch, tmp_path, rank=0, seed=0, case="mixed"):
    """One recorder of each package, with a writer each, fed the same
    stream; the wall/monotonic anchor pair is pinned so the files can
    match byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    monkeypatch.setattr(time, "monotonic", lambda: 999.0)
    out = []
    for pkg, name in ((jtrace, "jax"), (ptrace, "port")):
        path = tmp_path / name / f"tr.{rank}"
        path.parent.mkdir(exist_ok=True)
        rec = pkg.TraceRecorder(capacity=4096,
                                writer=pkg.TraceWriter(str(path), rank),
                                rank=rank)
        out.append((rec, path))
    monkeypatch.undo()
    stream = _stream(seed + 100 * rank, *CASES[case])
    for rec, _ in out:
        _feed(rec, stream)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_recorder_matches_jax(monkeypatch, tmp_path, case):
    """Summary, digest and histograms agree on every case."""
    (jrec, _), (prec, _) = _recorders(monkeypatch, tmp_path, case=case)
    assert prec.phase_summary() == jrec.phase_summary()
    assert prec.digest() == jrec.digest()
    assert prec.phase_histograms() == jrec.phase_histograms()
    assert prec.open_spans() == jrec.open_spans()
    s = prec.phase_summary()
    assert s["spans"] == CASES[case][0]
    assert ("legs_us" in s) == (CASES[case][2] > 0)
    assert s["phase_sum_us"] == pytest.approx(s["cycle_us"], abs=0.05)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_writer_merge_and_report_match_jax(monkeypatch, tmp_path,
                                                case):
    """Two ranks' writer files are byte-equal between the packages, and
    so are their merged perfetto JSON and critical-path reports."""
    paths = {"jax": [], "port": []}
    for rank in (0, 1):
        (jrec, jp), (prec, pp) = _recorders(monkeypatch, tmp_path, rank,
                                            case=case)
        jrec.close()
        prec.close()
        assert pp.read_bytes() == jp.read_bytes()
        paths["jax"].append(str(jp))
        paths["port"].append(str(pp))
    jranks = [jmerge.load_trace_file(p) for p in paths["jax"]]
    pranks = [pmerge.load_trace_file(p) for p in paths["port"]]
    merged = pmerge.merge_traces(pranks)
    assert merged == jmerge.merge_traces(jranks)
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    assert any(e.get("ph") == "s" for e in merged["traceEvents"])
    assert panalyze.render_report(pranks) == janalyze.render_report(jranks)
    assert panalyze.critical_path(pranks) == janalyze.critical_path(jranks)
    assert panalyze.phase_summary(pranks) == janalyze.phase_summary(jranks)


def test_torch_trace_cli_matches_jax(monkeypatch, tmp_path, capsys):
    """``python -m horovod_tpu_torch.trace <base> --report`` prints the
    JAX CLI's report, and ``-o`` writes the JAX CLI's merged file."""
    from horovod_tpu.trace.__main__ import main as jmain
    from horovod_tpu_torch.trace.__main__ import main as pmain
    for rank in (0, 1):
        for rec, _ in _recorders(monkeypatch, tmp_path, rank, seed=7):
            rec.close()
    assert jmain([str(tmp_path / "jax" / "tr"), "--report"]) == 0
    jtext = capsys.readouterr().out
    assert pmain([str(tmp_path / "port" / "tr"), "--report"]) == 0
    assert capsys.readouterr().out == jtext
    assert "critical-path attribution" in jtext
    outs = []
    for main, name in ((jmain, "jax"), (pmain, "port")):
        out = tmp_path / f"{name}.merged.json"
        assert main([str(tmp_path / name / "tr"), "-o", str(out)]) == 0
        outs.append(json.loads(out.read_text()))
    capsys.readouterr()
    assert outs[0] == outs[1]
    with pytest.raises(SystemExit):
        pmain([])
    assert pmain([str(tmp_path / "missing")]) == 1


def test_torch_snapshot_merge_matches_jax(monkeypatch, tmp_path):
    """Digest-level lanes from a monitor ``/snapshot`` dump (the digests
    that ride the side-channel) merge alike."""
    (jrec, _), (prec, _) = _recorders(monkeypatch, tmp_path, case="mixed")
    dump = {"table": {"0": {"trace": prec.digest()},
                      "1": {"trace": jrec.digest()}}}
    assert pmerge.merge_snapshot(dump) == jmerge.merge_snapshot(dump)
    assert pmerge.merge_snapshot(dump)["traceEvents"]


def test_torch_trace_env_parsing(monkeypatch):
    """The port's Config parses ``HOROVOD_TRACE`` as the JAX one does: a
    boolean arms the in-memory recorder, anything else is the file."""
    from horovod_tpu.common.config import Config as JaxConfig
    from horovod_tpu_torch.common.config import Config
    monkeypatch.delenv("HOROVOD_TRACE", raising=False)
    monkeypatch.delenv("HVD_TPU_TRACE", raising=False)
    assert Config.from_env().trace is False
    for value in ("1", "/tmp/tr.json", "0", "on", "no", ""):
        monkeypatch.setenv("HOROVOD_TRACE", value)
        got, want = Config.from_env(), JaxConfig.from_env()
        assert (got.trace, got.trace_filename) == (want.trace,
                                                   want.trace_filename)
    monkeypatch.setenv("HOROVOD_TRACE", "/tmp/tr.json")
    cfg = Config.from_env()
    assert cfg.trace is True and cfg.trace_filename == "/tmp/tr.json"
    monkeypatch.setenv("HOROVOD_TRACE_RING", "128")
    assert Config.from_env().trace_ring == 128


def test_torch_maybe_install(tmp_path):
    """Disarmed the engine's tracer is None; armed, a recorder of the
    rank, writing its file when the config names one."""
    from horovod_tpu_torch.common.config import Config
    assert ptrace.maybe_install(Config()) is None
    cfg = Config()
    cfg.trace = True
    rec = ptrace.maybe_install(cfg, rank=3)
    assert isinstance(rec, ptrace.TraceRecorder) and rec.rank == 3
    cfg.trace_filename = str(tmp_path / "tr.3")
    rec = ptrace.maybe_install(cfg, rank=3)
    rec.close()
    assert json.loads((tmp_path / "tr.3").read_text().splitlines()[0])[
        "rank"] == 3


def test_torch_stall_report_names_the_phase():
    """The port's stall warning names the phase a stuck entry's span is
    in (``ops/scheduler.py`` reads ``span.phase_name``)."""
    from horovod_tpu_torch.ops.scheduler import StallInspector
    from horovod_tpu_torch.utils.logging import get_logger
    rec = ptrace.TraceRecorder(capacity=64)
    insp = StallInspector(warn_after_s=0.0, shutdown_after_s=0.0)
    now = time.monotonic()
    span = rec.begin("stuck.t", now - 5.0, now - 4.9)
    span.t_ready = now - 4.0

    class Entry:
        name = "stuck.t"
        enqueue_time = now - 5.0

    Entry.span = span
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    try:
        insp.check([Entry()])
    finally:
        logger.removeHandler(handler)
    assert records and "stuck in phase copy_in" in records[0], records
