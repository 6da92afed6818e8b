"""The per-layer metrics that read the program's host spans: a traced CPU
rehearsal of each cell reports every one of its cells' (none needs the
card), finite; an untraced one reports none; each reader on a synthetic
``Record``, None when the traced stretch holds no span of the program (as
of a program without spans); and the span names are the program's."""
import json

import numpy as np
import pytest
from conftest import ROOT, SMALL

from vpbench import devtrace, harness, hostspans

SPAN_METRICS = {
    "snn_fullwidth.fleet64": {"bucket_prep_ms", "bucket_issue_ms", "bucket_fetch_ms",
                              "bucket_results_ms", "captures_per_job.serve"},
    "googlenet_conv1.riscv": {"job_init_ms", "job_fetch_ms", "captures_per_job.sim"},
}
SPAN_METRICS["snn_fullwidth.fleet8"] = SPAN_METRICS["snn_fullwidth.fleet64"]


def test_the_cells_list_their_span_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, names in SPAN_METRICS.items():
        w = next(w for w in spec["workloads"] if w["name"] == cell)
        listed = {m["name"] for m in harness.metrics_of(spec, w, True)}
        assert names <= listed
        assert not names & {m["name"] for m in harness.metrics_of(spec, w, False)}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_rehearsal_reports_the_span_metrics(cell, small_run):
    traced = small_run(cell, trace=True)["metrics"]
    assert SPAN_METRICS[cell] <= set(traced)
    for name in SPAN_METRICS[cell]:
        assert np.isfinite(traced[name]["value"]) and traced[name]["value"] >= 0
    # off the card nothing is captured
    assert traced[f"captures_per_job.{'sim' if 'riscv' in cell else 'serve'}"]["value"] == 0
    assert not SPAN_METRICS[cell] & set(small_run(cell, trace=False)["metrics"])


def _rec(host, **kw):
    rec = harness.Record(**kw)
    rec.trace = devtrace.Trace([], list(host), 1.0)
    return rec


FLEET = [("vpbench.flush", 0.0, 1.0),
         (hostspans.PREFIX + "serve.flush", 0.0, 0.9),
         (hostspans.PREP, 0.0, 0.1), (hostspans.DISPATCH, 0.1, 0.12), (hostspans.FETCH, 0.12, 0.4),
         (hostspans.RESULTS, 0.4, 0.7),
         (hostspans.PREP, 0.7, 0.75), (hostspans.DISPATCH, 0.75, 0.76),
         (hostspans.FETCH, 0.76, 0.8), (hostspans.DISPATCH, 0.8, 0.81),
         (hostspans.FETCH, 0.81, 0.85), (hostspans.RESULTS, 0.85, 0.9)]
SIM = [("vpbench.job", 0.0, 2.0), (hostspans.INIT, 0.0, 0.02),
       (hostspans.CAPTURE, 0.02, 0.1), (hostspans.DISPATCH, 0.1, 0.11),
       (hostspans.FETCH, 0.11, 1.0), (hostspans.DISPATCH, 1.0, 1.01),
       (hostspans.FETCH, 1.01, 1.5), ("vpbench.job", 2.0, 3.0),
       (hostspans.INIT, 2.0, 2.04), (hostspans.CAPTURE, 2.04, 2.1),
       (hostspans.DISPATCH, 2.1, 2.11), (hostspans.FETCH, 2.11, 2.9)]


def test_bucket_readers():
    rec = _rec(FLEET, syncs=10, served=40)  # 4 requests a fetch in the window
    assert harness.reader("bucket_prep_ms")(rec) == pytest.approx(75.0)
    assert harness.reader("bucket_issue_ms")(rec) == pytest.approx(20.0)
    assert harness.reader("bucket_fetch_ms")(rec) == pytest.approx(180.0)
    assert harness.reader("bucket_results_ms")(rec) == pytest.approx(175.0)
    assert harness.reader("captures_per_job.serve")(rec) == 0.0  # of 3 fetches x 4 requests
    rec.trace.host.append((hostspans.CAPTURE, 0.12, 0.2))
    assert harness.reader("captures_per_job.serve")(rec) == pytest.approx(1 / 12)


def test_job_readers():
    rec = _rec(SIM)
    assert harness.reader("job_init_ms")(rec) == pytest.approx(30.0)
    assert harness.reader("job_fetch_ms")(rec) == pytest.approx((0.89 + 0.49 + 0.79) / 2 * 1e3)
    assert harness.reader("captures_per_job.sim")(rec) == 1.0


NAMES = ["bucket_prep_ms", "bucket_issue_ms", "bucket_fetch_ms", "bucket_results_ms",
         "captures_per_job.serve", "job_init_ms", "job_fetch_ms", "captures_per_job.sim"]


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_gives_none_without_the_programs_spans(name):
    # a program without spans: only the benchmark's own and the ops
    rec = _rec([("vpbench.flush", 0.0, 1.0), ("vpbench.job", 0.0, 1.0),
                ("aten::clone", 0.1, 0.2)], syncs=10, served=40)
    assert harness.reader(name)(rec) is None
    rec.trace = None  # an untraced run
    assert harness.reader(name)(rec) is None


def test_span_names_are_the_programs():
    from repro_torch.obs import spans

    assert (hostspans.PREP, hostspans.DISPATCH, hostspans.FETCH, hostspans.RESULTS,
            hostspans.INIT, hostspans.CAPTURE) == \
        (spans.PREP, spans.DISPATCH, spans.FETCH, spans.RESULTS, spans.INIT, spans.CAPTURE)
    assert all(n.startswith(hostspans.PREFIX) for n in (spans.FLUSH, spans.PREP))
