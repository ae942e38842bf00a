"""The port's telemetry spine (`repro_torch.obs`) on the CPU: the mirror of
`tests/test_obs.py`, and parity with the reference's `repro.obs`.

The contract under test, as the reference's: recording never reads a
device value (values materialise at drain), the trainer's history keeps
its shape while backed by the bus, the human log lines are the
reference's format, telemetry is a bitwise no-op on the trajectory, the
drift monitor warns exactly once per band excursion, and the declared
schema rejects undeclared keys. Parity: the same records render the
same markdown in both packages, the schema and the serving and cluster
key tuples are equal, the drift monitor answers the same, and the byte
model predicts the reference's bytes at the same plan shape.

Two tests of `tests/test_obs.py` have no counterpart here: the jit
retrace check (`test_bus_recording_keeps_single_trace`; the port has no
jit) and the benchmark artifacts' env block (`test_bench_env_block`;
`benchmarks/` is not ported).
"""
import pytest

torch = pytest.importorskip("torch")

import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import FOPOConfig as JFOPOConfig  # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan  # noqa: E402
from repro.obs import drift as jdrift  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro_torch.core import ExecutionPlan, FOPOConfig  # noqa: E402
from repro_torch.data import SyntheticConfig, generate_sessions  # noqa: E402
from repro_torch.health import FaultPlan, HealthConfig  # noqa: E402
from repro_torch.health.guard import ESS_COLLAPSE, verdict_record  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    HISTORY_SCHEMA,
    DriftConfig,
    DriftMonitor,
    HumanLogSink,
    JSONLSink,
    MetricsBus,
    ObsConfig,
    ObsRun,
    RingSink,
    Tracer,
    span,
    tracing,
    validate_history,
)
from repro_torch.obs import drift as tdrift  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs import schema as tschema  # noqa: E402
from repro_torch.obs import trace as trace_mod  # noqa: E402
from repro_torch.obs.report import percentile, render_run  # noqa: E402
from repro_torch.obs.schema import empty_history, history_from_records  # noqa: E402
from repro_torch.obs.sinks import format_rollback_line, format_train_line  # noqa: E402
from repro_torch.train import FOPOTrainer, TrainerConfig  # noqa: E402

# ---------------------------------------------------------------------------
# shared fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ds():
    full = generate_sessions(SyntheticConfig(
        num_items=300, num_users=200, embed_dim=16, session_len=8, seed=0
    ))
    train, _ = full.split(0.85, seed=0)
    return train


def _trainer(ds, *, obs=None, health=None, fault=None, steps=8, seed=0, **fopo_kw):
    fopo = FOPOConfig(
        num_items=300, num_samples=32, top_k=16, epsilon=0.8,
        **({"retriever": "streaming"} | fopo_kw),
    )
    cfg = TrainerConfig(
        estimator="fopo", fopo=fopo, batch_size=16, learning_rate=1e-3,
        num_steps=steps, checkpoint_every=0, seed=seed, health=health,
        obs=obs,
    )
    return FOPOTrainer(cfg, ds, fault_plan=fault, device="cpu")


# ---------------------------------------------------------------------------
# the metrics bus
# ---------------------------------------------------------------------------

def test_bus_records_kinds_and_totals():
    ring = RingSink()
    bus = MetricsBus([ring])
    bus.counter("c", 2.0)
    bus.counter("c", 3.0, step=4)
    bus.gauge("g", 1.5, step=1, route="x")
    bus.timing("t", 0.25)
    bus.event("e", {"a": 1})
    # nothing reaches a sink before drain
    assert bus.pending == 5 and len(ring.records) == 0
    assert bus.drain() == 5 and bus.pending == 0
    assert [r["kind"] for r in ring.records] == [
        "counter", "counter", "gauge", "timing", "event"
    ]
    assert bus.total("c") == 5.0 and bus.total("never") == 0.0
    g = ring.records[2]
    assert g["step"] == 1 and g["labels"] == {"route": "x"}


class _Probe:
    """float() tripwire: reading the value at record time is the host
    sync the bus must never add."""

    def __init__(self):
        self.allowed = False

    def __float__(self):
        if not self.allowed:
            raise AssertionError("device value read at record time")
        return 7.0


def test_bus_defers_value_reads_to_drain():
    ring = RingSink()
    bus = MetricsBus([ring])
    probe = _Probe()
    bus.gauge("loss", probe, step=0)  # must not call float() here
    assert bus.pending == 1
    probe.allowed = True  # "the owner synchronised"
    bus.drain()
    assert ring.records[0]["value"] == 7.0


def test_ring_capacity_bounds():
    ring = RingSink(capacity=3)
    bus = MetricsBus([ring])
    for i in range(10):
        bus.gauge("g", float(i))
    bus.drain()
    assert [r["value"] for r in ring.records] == [7.0, 8.0, 9.0]


def test_jsonl_sink_roundtrip_and_append(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = JSONLSink(path)
    sink.emit({"t": 0, "kind": "event", "name": "e", "value": {"x": 1}})
    sink.emit({"t": 0, "kind": "event", "name": "bad", "value": object()})
    sink.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["value"] == {"x": 1}
    assert isinstance(lines[1]["value"], str)  # repr fallback, not a crash
    # append mode: a second train() call on the same run_dir extends
    sink2 = JSONLSink(path)
    sink2.emit({"t": 1, "kind": "gauge", "name": "g", "value": 2.0})
    sink2.close()
    assert len(open(path).readlines()) == 3


def test_jsonl_sink_retries_transient_write_failures(tmp_path):
    # two injected failures, then success: the record lands after
    # reopen + retry
    path = str(tmp_path / "m.jsonl")
    sink = JSONLSink(path, retries=3, backoff=0.0)
    fails = [2]
    real_write = sink._f.write

    class Flaky:
        def write(self, s):
            if fails[0] > 0:
                fails[0] -= 1
                raise OSError("injected transient IO failure")
            return real_write(s)

        def close(self):
            pass

        def flush(self):
            pass

    sink._f = Flaky()
    sink.emit({"t": 0, "kind": "gauge", "name": "g", "value": 1.0})
    sink.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines and lines[-1]["value"] == 1.0


def test_jsonl_sink_disarms_after_exhausted_retries(tmp_path, capsys):
    # a persistent failure disarms the sink (emits become no-ops)
    # instead of raising into the serving loop
    path = str(tmp_path / "m.jsonl")
    sink = JSONLSink(path, retries=2, backoff=0.0)

    class Dead:
        def write(self, s):
            raise OSError("disk on fire")

        def close(self):
            raise OSError("still on fire")

        def flush(self):
            pass

    sink._f = Dead()
    sink._reopen = lambda: None  # reopen keeps handing back the dead handle
    sink.emit({"t": 0, "kind": "gauge", "name": "g", "value": 1.0})
    assert sink._f is None
    assert "disarmed" in capsys.readouterr().err
    sink.emit({"t": 0, "kind": "gauge", "name": "g", "value": 2.0})  # no-op
    sink.close()  # and close stays safe


def test_jsonl_sink_backoff_sleep_is_bounded(tmp_path, monkeypatch, capsys):
    # total sleep over the retries is capped at max_sleep_s, then the
    # sink disarms
    import repro_torch.obs.sinks as sinks_mod

    slept = []
    monkeypatch.setattr(sinks_mod.time, "sleep", lambda s: slept.append(s))
    path = str(tmp_path / "m.jsonl")
    sink = JSONLSink(path, retries=8, backoff=0.05, max_sleep_s=0.08)

    class Dead:
        def write(self, s):
            raise OSError("disk on fire")

        def close(self):
            pass

        def flush(self):
            pass

    sink._f = Dead()
    sink._reopen = lambda: None
    sink.emit({"t": 0, "kind": "gauge", "name": "g", "value": 1.0})
    assert sink._f is None  # still disarms
    assert sum(slept) <= 0.08 + 1e-9
    capsys.readouterr()


def test_human_log_sink_prints_only_log_records():
    out = io.StringIO()
    sink = HumanLogSink(stream=out)
    sink.emit({"t": 0.0, "kind": "gauge", "name": "loss", "value": 1.0})
    sink.emit({"t": 0.0, "kind": "event", "name": "log", "value": "hello"})
    assert out.getvalue() == "hello\n"  # verbatim, no stamp by default
    stamped = io.StringIO()
    HumanLogSink(stream=stamped, timestamps=True).emit(
        {"t": 0.0, "kind": "event", "name": "log", "value": "hello"}
    )
    assert stamped.getvalue().endswith(" hello\n")
    assert len(stamped.getvalue()) > len("hello\n")


def test_format_helpers_match_legacy_print_strings():
    aux = {"ess": 25.44, "rbar": 0.0143, "max_wbar": 0.0621}
    step, loss = 40, -0.0123456
    legacy = f"step {step}: loss={loss:+.5f}"
    legacy += (
        f" ess={aux['ess']:.1f} rbar={aux['rbar']:+.4f}"
        f" max_wbar={aux['max_wbar']:.3f}"
    )
    assert format_train_line(step, loss, aux) == legacy
    assert (
        format_train_line(step, loss, aux, ("ess_collapse",), True)
        == legacy + " health=ess_collapse [degraded:exact]"
    )
    assert format_train_line(3, 0.5) == "step 3: loss=+0.50000"
    assert format_rollback_line(7, 4, 2) == "step 7: ROLLBACK to 4 (restart #2)"


# ---------------------------------------------------------------------------
# phase tracing and the profiler
# ---------------------------------------------------------------------------

def test_tracer_spans_nest_and_write(tmp_path):
    tr = Tracer()
    with tracing(tr):
        with span("outer", step=1):
            with span("inner"):
                pass
    # complete events append at close: inner first, outer envelops it
    assert [e["name"] for e in tr.events] == ["inner", "outer"]
    inner, outer = tr.events
    assert outer["dur"] >= inner["dur"]
    assert all(e["ph"] == "X" for e in tr.events)
    assert outer["args"] == {"step": 1}
    tr.instant("mark", why="test")
    doc = json.load(open(tr.write(str(tmp_path / "trace.json"))))
    assert {e["name"] for e in doc["traceEvents"]} == {"inner", "outer", "mark"}
    assert doc["traceEvents"][-1]["ph"] == "i"


def test_span_is_noop_without_tracer():
    assert trace_mod.current() is None
    with span("phantom"):  # must not raise, must not record anywhere
        pass
    assert trace_mod.current() is None
    tr = Tracer()
    trace_mod.activate(tr)
    try:
        assert trace_mod.current() is tr
        with span("real"):
            pass
    finally:
        trace_mod.deactivate()
    assert trace_mod.current() is None and [e["name"] for e in tr.events] == ["real"]


def test_torch_profiler_exports_a_chrome_trace(tmp_path):
    """On the CPU the session records the host's operators (on a card
    also its kernels, which `chip_smoke.py` checks); a second session
    cannot start while one runs."""
    log_dir = str(tmp_path / "torchprof")
    assert trace_mod.start_torch_profiler(log_dir)
    try:
        assert not trace_mod.start_torch_profiler(log_dir)
        x = torch.ones(64, 64)
        (x @ x).sum()
    finally:
        path = trace_mod.stop_torch_profiler()
    assert path == os.path.join(log_dir, trace_mod.PROFILE_FILE)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names
    assert trace_mod.stop_torch_profiler() is None  # nothing left running


# ---------------------------------------------------------------------------
# roofline-drift monitor
# ---------------------------------------------------------------------------

def _drift_cfg(module=None, **kw):
    base = dict(band=0.5, ema_decay=0.5, calibration_steps=2,
                skip_steps=0, rearm_frac=0.6)
    base.update(kw)
    return (module.DriftConfig if module else DriftConfig)(**base)


def test_drift_exactly_one_warning_per_excursion():
    m = DriftMonitor(1.0, _drift_cfg())
    assert m.observe(1.0) is None and m.observe(1.0) is None  # calibration
    # slow excursion: only the band crossing warns, staying out is quiet
    fired = [w for w in (m.observe(4.0) for _ in range(6)) if w]
    assert len(fired) == 1
    assert fired[0]["direction"] == "slow"
    assert fired[0]["event"] == "roofline_drift"
    # back inside the re-arm band: silent, but the monitor re-arms
    assert all(m.observe(1.0) is None for _ in range(10))
    # fast excursion fires exactly once again
    fired2 = [w for w in (m.observe(0.05) for _ in range(6)) if w]
    assert len(fired2) == 1 and fired2[0]["direction"] == "fast"
    assert m.warnings == 2


def test_drift_hysteresis_no_spam_at_band_edge():
    """A ratio hovering just outside the band after the first crossing
    must not re-warn until it first re-enters the re-arm band."""
    m = DriftMonitor(1.0, _drift_cfg(ema_decay=0.1))
    m.observe(1.0), m.observe(1.0)
    warns = sum(1 for _ in range(20) if m.observe(1.6))  # hovers ~1.6
    assert warns == 1
    # dip only into the outer band (not the re-arm band): still armed off
    m.observe(1.4)
    assert m.observe(1.7) is None


def test_drift_skip_steps_discards_compile_step():
    m = DriftMonitor(0.001, DriftConfig(calibration_steps=3, skip_steps=1))
    assert m.observe(50.0) is None  # the build step: not even calibration
    for _ in range(3):
        m.observe(0.01)
    assert m.scale == pytest.approx(10.0)  # poison-free baseline
    m.observe(0.01)
    assert m.ema == pytest.approx(1.0)


def test_drift_config_validation():
    for bad in (
        dict(band=0.0), dict(ema_decay=1.0), dict(ema_decay=0.0),
        dict(calibration_steps=0), dict(rearm_frac=0.0),
        dict(rearm_frac=1.0), dict(skip_steps=-1),
    ):
        with pytest.raises(ValueError):
            DriftConfig(**bad)
    with pytest.raises(ValueError):
        DriftMonitor(0.0)


@pytest.mark.parametrize("kw", [dict(), dict(ema_decay=0.1), dict(skip_steps=2, band=0.3)])
def test_drift_monitor_matches_reference(kw):
    """Fed the same seconds, both monitors give the same warnings, EMA
    and scale after every observation."""
    seconds = np.random.default_rng(3).lognormal(0.0, 0.6, 80) * 1e-3
    seconds[30:40] *= 5.0  # a slow excursion
    seconds[60:70] *= 0.1  # a fast one
    tm = DriftMonitor(1e-4, _drift_cfg(**kw))
    jm = jdrift.DriftMonitor(1e-4, _drift_cfg(jdrift, **kw))
    for s in seconds.tolist():
        assert tm.observe(s) == jm.observe(s)
        assert (tm.ema, tm.scale) == (jm.ema, jm.scale)
    assert tm.warnings == jm.warnings >= 2


def test_predict_step_bytes_scales_with_shape():
    plan = ExecutionPlan.resolve(FOPOConfig(
        num_items=500, num_samples=32, top_k=16, epsilon=0.8,
        retriever="streaming",
    ))
    pred = tdrift.predict_step_bytes(plan, 16, 8)
    assert pred["total_bytes"] > 0
    assert pred["total_bytes"] == (
        pred["snis_bytes"] + pred["sampler_bytes"]
        + pred["retrieval_bytes"] + pred["comms_bytes"]
    )
    assert tdrift.predict_step_seconds(plan, 16, 8) == pytest.approx(
        pred["total_bytes"] / 3.35e12
    )
    # the scaling is the signal: a bigger batch must predict more bytes
    assert tdrift.predict_step_bytes(plan, 32, 8)["total_bytes"] > pred["total_bytes"]


@pytest.mark.parametrize("retriever", ["streaming", "exact", "ivf", "ivf_pallas", "pallas"])
@pytest.mark.parametrize("fused,fused_sampler", [(False, False), (True, True)])
def test_predict_step_bytes_matches_reference(retriever, fused, fused_sampler):
    """The port's copy of the byte formulas against the reference's
    models (`benchmarks/roofline.py`) at the same plan shape: the paper's
    fopo step (P 750,000, L 100, S 1000, K 256, B 32) and a small one."""
    pytest.importorskip("benchmarks.roofline")
    for p, l, s, k, b in ((750_000, 100, 1000, 256, 32), (500, 8, 32, 16, 16)):
        plan = types.SimpleNamespace(
            cfg=types.SimpleNamespace(num_items=p, num_samples=s, top_k=k,
                                      retriever=retriever),
            fused=fused, fused_sampler=fused_sampler, dist=None,
        )
        assert tdrift.predict_step_bytes(plan, b, l) == jdrift.predict_step_bytes(plan, b, l)
        # the same bytes over the card's rate, not the reference's 819e9
        assert tdrift.predict_step_seconds(plan, b, l) * 3.35e12 == pytest.approx(
            jdrift.predict_step_seconds(plan, b, l) * 819e9)


@pytest.mark.parametrize("retriever", ["streaming", "exact", "pallas"])
def test_predict_step_bytes_of_resolved_plans_match(retriever):
    """Resolved plans of both packages, with the kernel knobs."""
    pytest.importorskip("benchmarks.roofline")
    kw = dict(num_items=500, num_samples=40, top_k=16, epsilon=0.8, retriever=retriever,
              fused=True, fused_sampler=True, sample_tile=8)
    tplan, jplan = ExecutionPlan.resolve(FOPOConfig(**kw)), JPlan.resolve(JFOPOConfig(**kw))
    assert (tplan.fused, tplan.fused_sampler) == (jplan.fused, jplan.fused_sampler)
    assert tdrift.predict_step_bytes(tplan, 16, 8) == jdrift.predict_step_bytes(jplan, 16, 8)


# ---------------------------------------------------------------------------
# the declared history schema
# ---------------------------------------------------------------------------

def test_validate_history_rejects_undeclared_keys():
    h = empty_history()
    h["total_time"] = 0.0
    assert validate_history(h) is h  # declared shape passes, chains
    h["my_new_metric"] = []
    with pytest.raises(KeyError, match="my_new_metric"):
        validate_history(h)


def test_history_from_records_folds_the_stream():
    recs = [
        {"kind": "gauge", "name": "loss", "value": 1.0},
        {"kind": "timing", "name": "step_time", "value": 0.1},
        {"kind": "event", "name": "reward", "value": {"step": 4, "value": 0.5}},
        {"kind": "event", "name": "health",
         "value": {"step": 1, "verdict": 8, "checks": ["ess_collapse"]}},
        {"kind": "gauge", "name": "bus_only_metric", "value": 9.0},
        {"kind": "event", "name": "log", "value": "step 1: ..."},
    ]
    h = history_from_records(recs)
    assert h["loss"] == [1.0] and h["step_time"] == [0.1]
    assert h["reward"] == [(4, 0.5)]  # the (step, value) tuple shape
    assert h["health"][0]["verdict"] == 8
    # bus-only records exist in the stream, not in the history view
    assert "bus_only_metric" not in h and "log" not in h
    assert set(h) <= set(HISTORY_SCHEMA)


def test_verdict_record_shape():
    assert verdict_record(5, ESS_COLLAPSE) == {
        "step": 5, "verdict": ESS_COLLAPSE, "checks": ["ess_collapse"],
    }


def test_schema_and_key_tuples_equal_the_reference():
    assert tschema.HISTORY_SCHEMA == jschema.HISTORY_SCHEMA
    for name in ("SERIES_KEYS", "EVENT_KEYS", "SCALAR_KEYS", "SERVE_TIMING_KEYS",
                 "SERVE_GAUGE_KEYS", "SERVE_CLUSTER_COUNTER_KEYS",
                 "SERVE_CLUSTER_TIMING_KEYS"):
        assert getattr(tschema, name) == getattr(jschema, name), name
    assert set(tschema.__all__) == set(jschema.__all__)


# ---------------------------------------------------------------------------
# trainer integration
# ---------------------------------------------------------------------------

def test_trainer_history_backed_by_bus(ds):
    hist = _trainer(ds).train(6)
    validate_history(hist)
    assert len(hist["loss"]) == len(hist["step_time"]) == len(hist["ess"]) == 6
    assert all(isinstance(v, float) for v in hist["loss"])  # drained, not tensors
    assert hist["total_time"] > 0
    assert hist["health"] == [] and hist["events"] == []


def test_trainer_log_lines_byte_identical_to_legacy(ds, capsys):
    """The human sink's cadence lines reproduce the reference's print
    format exactly, rebuilt here from the history values."""
    hist = _trainer(ds).train(6, log_every=2)
    out = capsys.readouterr().out.splitlines()
    expect = [
        f"step {s}: loss={hist['loss'][s - 1]:+.5f}"
        f" ess={hist['ess'][s - 1]:.1f}"
        f" rbar={hist['rbar'][s - 1]:+.4f}"
        f" max_wbar={hist['max_wbar'][s - 1]:.3f}"
        for s in (2, 4, 6)
    ]
    assert out == expect


def test_obs_is_bitwise_noop_on_trajectory(ds, tmp_path):
    bare = _trainer(ds)
    instrumented = _trainer(ds, obs=ObsConfig(
        run_dir=str(tmp_path / "run"),
        drift=DriftConfig(calibration_steps=2),
    ))
    h_bare = bare.train(6)
    h_obs = instrumented.train(6)
    assert h_bare["loss"] == h_obs["loss"]
    assert torch.equal(bare.params["w"], instrumented.params["w"])


@pytest.mark.parametrize("profiler", [False, True])
def test_obs_kernel_configuration_is_a_bitwise_noop_and_leaves_artifacts(
        ds, tmp_path, profiler):
    """The kernel configuration (pallas retriever, fused surrogate, fused
    sampler; their plain versions here) for 6 steps with telemetry on
    and off from the same seeds: theta, Adam state and losses equal bit
    for bit; the run directory holds the JSONL stream, the trace with the
    plan's phases, (with the profiler) the torch.profiler trace, and a
    report with the percentile rows and the drift series."""
    run_dir = str(tmp_path / "run")
    kw = dict(retriever="pallas", fused=True, fused_sampler=True, sample_tile=8)
    obs = ObsConfig(run_dir=run_dir, drift=DriftConfig(calibration_steps=2),
                    torch_profiler=profiler)
    bare, instrumented = _trainer(ds, **kw), _trainer(ds, obs=obs, **kw)
    h_bare, h_obs = bare.train(6), instrumented.train(6)
    assert h_bare["loss"] == h_obs["loss"] and h_bare["ess"] == h_obs["ess"]
    for a, b in zip(torch.utils._pytree.tree_leaves((bare.params, bare.opt_state)),
                    torch.utils._pytree.tree_leaves((instrumented.params,
                                                     instrumented.opt_state))):
        assert torch.equal(a, b)
    # 6 steps - 1 skipped - 2 calibrating = 3 drift points
    assert len(h_obs["drift"]) == 3 and h_bare["drift"] == []
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    for name in ("loss", "step_time", "ess", "rbar", "max_wbar"):
        assert sum(r["name"] == name for r in records) == 6, name
    spans = {e["name"] for e in json.load(open(os.path.join(run_dir, "trace.json")))[
        "traceEvents"]}
    assert {"dispatch", "drain", "user_embedding", "retrieval", "sample", "reward",
            "surrogate"} <= spans
    prof = os.path.join(run_dir, "torchprof", trace_mod.PROFILE_FILE)
    assert os.path.exists(prof) == profiler
    text = open(render_run(run_dir)).read()
    assert "| loss | 6 |" in text and "| ess | 6 |" in text and "drift_ratio" in text


def test_obsrun_without_config_still_backs_history():
    with ObsRun(None) as run:
        run.bus.gauge("loss", 1.0, step=0)
        run.observe_step_time(0.1, 0)
        hist = run.history()
    assert hist["loss"] == [1.0]
    assert hist["step_time"] == [0.1]
    assert hist["drift"] == []  # no prediction -> monitor off


def test_monitor_bus_binding_emits_gauges():
    from repro_torch.health import IndexHealthConfig, IndexHealthMonitor

    ring = RingSink()
    bus = MetricsBus([ring])
    monitor = IndexHealthMonitor(IndexHealthConfig(
        probe_every=1, recall_floor=0.9, cooldown=0
    ))
    monitor.bind_bus(bus)
    assert monitor.observe(0.5, 0) == "compact"
    bus.drain()
    names = [r["name"] for r in ring.records]
    assert "index_probe_recall" in names
    assert "index_overflow_delta" in names
    assert bus.total("index_ladder_escalations") == 1.0


# ---------------------------------------------------------------------------
# run artifacts + report
# ---------------------------------------------------------------------------

def test_run_artifacts_and_report(ds, tmp_path):
    """The artifact path end to end: a guarded run with a scripted ESS
    collapse leaves a JSONL stream, a Chrome trace with the phase spans,
    and a rendered report with loss / ESS percentiles, the health event
    and the roofline-drift series."""
    run_dir = str(tmp_path / "run")
    trainer = _trainer(
        ds,
        obs=ObsConfig(run_dir=run_dir, drift=DriftConfig(calibration_steps=2)),
        health=HealthConfig(ess_floor=1.0),
        fault=FaultPlan(ess_collapse_at=(3,), ess_value=0.5),
        steps=10,
    )
    hist = trainer.train(10, log_every=5)
    assert any("ess_collapse" in e["checks"] for e in hist["health"])
    assert len(hist["drift"]) > 0

    records = [json.loads(line)
               for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert any(r["name"] == "loss" for r in records)
    assert any(r["name"] == "health" for r in records)

    doc = json.load(open(os.path.join(run_dir, "trace.json")))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"dispatch", "drain", "retrieval", "sample", "surrogate"} <= names

    text = open(render_run(run_dir)).read()
    assert "| loss |" in text and "| ess |" in text  # percentile rows
    assert "ess_collapse" in text  # the health timeline
    assert "drift_ratio" in text  # the plot-ready drift series


def test_percentile_nearest_rank():
    vs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(vs, 0) == 1.0
    assert percentile(vs, 100) == 4.0
    assert percentile([5.0], 99) == 5.0
    rng = np.random.default_rng(0)
    for _ in range(20):
        xs = rng.standard_normal(int(rng.integers(1, 40))).tolist()
        p = float(rng.uniform(0, 100))
        assert percentile(xs, p) == jreport.percentile(xs, p)


def _report_records() -> list:
    """A record stream with every section the report renders: step
    series, drift and its warnings, guard verdicts, a rollback, ladder
    probes, engine records labelled by replica, cluster counters and
    timings."""
    rng = np.random.default_rng(5)
    recs = []
    for s in range(12):
        for name in ("loss", "ess", "rbar", "max_wbar"):
            recs.append({"t": float(s), "kind": "gauge", "name": name, "step": s,
                         "value": float(rng.standard_normal())})
        recs.append({"t": float(s), "kind": "timing", "name": "step_time", "step": s,
                     "value": float(rng.uniform(1e-3, 3e-3))})
        if s >= 4:
            recs.append({"t": float(s), "kind": "gauge", "name": "drift", "step": s,
                         "value": float(rng.uniform(0.5, 2.0))})
    recs += [
        {"t": 3.0, "kind": "event", "name": "health", "step": 3,
         "value": verdict_record(3, ESS_COLLAPSE)},
        {"t": 5.0, "kind": "event", "name": "events", "step": 5,
         "value": {"step": 5, "event": "rollback", "to": 2, "restarts": 1}},
        {"t": 6.0, "kind": "event", "name": "events", "step": 6,
         "value": {"step": 6, "event": "custom", "x": 1}},
        {"t": 7.0, "kind": "event", "name": "drift_events", "step": 7,
         "value": {"event": "roofline_drift", "direction": "slow", "ema": 1.71,
                   "ratio": 2.2, "band": 0.5, "step": 7}},
        {"t": 8.0, "kind": "event", "name": "index_health", "step": 8,
         "value": {"step": 8, "recall": 0.42, "overflow": 3, "action": "compact"}},
        {"t": 9.0, "kind": "event", "name": "index_health", "step": 9,
         "value": {"step": 9, "recall": None, "overflow": 0, "action": None}},
        {"t": 9.5, "kind": "event", "name": "log", "value": "a log line"},
    ]
    for rep in range(3):
        for b in range(2 + rep):
            lab = {"replica": rep}
            recs.append({"t": 10.0, "kind": "gauge", "name": "serve_batch_size",
                         "step": b, "labels": lab, "value": float(4 - b)})
            recs.append({"t": 10.0, "kind": "gauge", "name": "serve_occupancy",
                         "step": b, "labels": lab, "value": (4 - b) / 4})
            recs.append({"t": 10.0, "kind": "timing", "name": "serve_batch_service",
                         "step": b, "labels": lab, "value": float(rng.uniform(0.001, 0.01))})
            for r in range(4 - b):
                recs.append({"t": 10.0, "kind": "timing", "name": "serve_latency",
                             "step": r, "labels": lab,
                             "value": float(rng.uniform(0.001, 0.02))})
                recs.append({"t": 10.0, "kind": "timing", "name": "serve_queue_wait",
                             "step": r, "labels": lab,
                             "value": float(rng.uniform(0.0, 0.01))})
    recs.append({"t": 11.0, "kind": "counter", "name": "serve_abandoned",
                 "labels": {"replica": 1}, "value": 4.0})
    for name in ("serve_retries", "serve_replica_deaths", "serve_rebalances",
                 "serve_hedges", "serve_requests"):
        recs.append({"t": 11.0, "kind": "counter", "name": name, "value": 2.0})
    for i in range(20):
        for name in ("serve_cluster_latency", "serve_cluster_queue_wait"):
            recs.append({"t": 12.0, "kind": "timing", "name": name, "step": i,
                         "value": float(rng.uniform(0.0, 0.03))})
    return recs


def test_render_equals_the_reference(tmp_path):
    """One record list renders the same markdown in both packages, with
    the Serving, Cluster, health, ladder and drift sections; so does the
    JSONL stream both read back from a run directory."""
    recs = _report_records()
    text = treport.render(recs, title="t")
    assert text == jreport.render(recs, title="t")
    for section in ("## Step metrics", "## Health events", "## Serving", "## Cluster",
                    "## Index health (degradation ladder)", "## Roofline drift"):
        assert section in text, section
    assert treport.render([]) == jreport.render([])
    with ObsRun(ObsConfig(run_dir=str(tmp_path), drift=None)) as run:
        for r in recs:
            record = getattr(run.bus, r["kind"])  # counter, gauge, timing or event
            record(r["name"], r["value"], step=r.get("step"), **r.get("labels", {}))
    loaded = treport.load_records(str(tmp_path))
    assert loaded == jreport.load_records(str(tmp_path))
    assert treport.render(loaded) == jreport.render(loaded)


def test_report_cli_writes_the_report(tmp_path, capsys):
    with ObsRun(ObsConfig(run_dir=str(tmp_path), drift=None)) as run:
        run.bus.gauge("loss", 0.5, step=0)
    out = str(tmp_path / "out.md")
    treport.main([str(tmp_path), "-o", out])
    assert capsys.readouterr().out.strip() == out
    assert open(out).read() == jreport.render(jreport.load_records(str(tmp_path)),
                                              title=f"Run report — {tmp_path}")
    with pytest.raises(FileNotFoundError, match="ObsConfig"):
        treport.load_records(str(tmp_path / "nowhere"))
