"""The readers of the port's spans (`slowflow_tpu_torch.utils.phases.spans()`)
on a recorded span list beside recorded device events, on the CPU: idle
seconds inside stage 3's init and alternation spans, the jet solve's
exit-flag reads per jet and the share of the untraced idle time they
hold; spans cut to the traced calls' range, those outside it and flag
reads outside a `sf.call` left out; no reading where the port keeps no
spans or nothing was traced."""
import pytest

from benchmarks import harness
from slowflow_tpu_torch.utils import phases

MS = 1_000_000


def reader(name: str):
    return harness.load_part(harness.BENCH_DIR, "metrics", name, ".py")


def use_spans(monkeypatch, spans):
    """Make the port report `spans`: (name, start ms, end ms, parent)
    tuples, each root its own thread's outermost span."""
    kept = []
    for name, a, b, parent in spans:
        root = len(kept) if parent is None else kept[parent].root
        kept.append(phases.Span(name, a * MS, b * MS, parent, 1, root))
    monkeypatch.setattr(phases, "spans", lambda: (kept, 0))


def kernel(a, b):
    return ("some_kernel", True, a * MS, b * MS)


def host(name, a, b):
    return (name, False, a * MS, b * MS)


def tracking_rec(events):
    return dict(events=events, unit="finals", units=2, calls=2)


def test_idle_inside_the_init_and_alternation_spans(monkeypatch):
    use_spans(monkeypatch, [
        ("dt.call", 10, 500, None),
        ("dt.init_final", 10, 210, 0),  # kernels 50-100, 150-170, 200-220
        ("epic.main_dt", 40, 60, 1),
        ("dt.alternate", 210, 300, 0),          # kernels 200-220, 290-310
        ("dt.call", 500, 990, None),
        ("dt.init_final", 500, 640, 4),         # no kernel: 140 ms idle
        ("dt.alternate", 700, 800, 4),          # kernel 650-1000 covers it
        ("dt.init_final", 1200, 1400, None),    # after the traced range
    ])
    events = [host("cudaLaunchKernel", 0, 1), kernel(50, 100),
              kernel(150, 170), kernel(160, 165), kernel(200, 220),
              kernel(290, 310), kernel(650, 1000)]
    rec = tracking_rec(events)
    # (200 - 50 - 20 - 10 + 140) ms over 2 finals
    assert reader("init_idle_s_per_final.dt").read(rec) == \
        pytest.approx(0.260 / 2)
    # (90 - 10 - 10 + 0) ms over 2 finals
    assert reader("alternate_idle_s_per_final.dt").read(rec) == \
        pytest.approx(0.070 / 2)
    assert reader("flag_reads_per_jet.sf").read(rec) is None


def test_no_reading_without_spans_or_a_trace(monkeypatch):
    use_spans(monkeypatch, [("dt.init_final", 10, 20, None),
                            ("graph.flag_read", 30, 40, None)])
    rec = tracking_rec([kernel(0, 100)])
    for name in ("init_idle_s_per_final.dt", "alternate_idle_s_per_final.dt",
                 "flag_reads_per_jet.sf", "flag_read_idle_pct.sf"):
        assert reader(name).read(dict(rec, events=None)) is None, name
    # a flag read inside no `sf.call` is not the jet solve's
    jets = dict(rec, unit="jets")
    assert reader("flag_reads_per_jet.sf").read(jets) is None
    assert reader("init_idle_s_per_final.dt").read(jets) is None
    # the port before its spans: the readers find nothing, and do not raise
    monkeypatch.delattr(phases, "spans")
    assert reader("init_idle_s_per_final.dt").read(rec) is None
    assert reader("flag_read_idle_pct.sf").read(jets) is None


def jet_spans(monkeypatch, walls=(0.5, 0.157, 0.157)):
    """A traced call of 4 jets (records 2-130 ms, kernels busy 87 ms) and
    untraced calls after it; `walls` the window's calls, the first traced."""
    use_spans(monkeypatch, [
        ("pipeline", 0, 100, None),         # a caller's span around the call
        ("sf.call", 1, 100, 0),
        ("graph.flag_read", 1, 20, 1),      # cut to 2-20: idle 2-4, 10-20
        ("graph.flag_read", 40, 41, 1),     # a kernel runs throughout
        ("graph.flag_read", 60, 80, 1),     # idle 70-72
        ("dt.call", 100, 130, None),
        ("graph.flag_read", 105, 120, 5),   # stage 3's, not the jet solve's
        ("sf.call", 200, 300, None),        # after the traced range
        ("graph.flag_read", 210, 220, 7),
    ])
    events = [host("cudaGraphLaunch", 2, 3), kernel(4, 10), kernel(22, 30),
              kernel(26, 45), kernel(50, 70), kernel(72, 90),
              kernel(110, 130)]
    window = harness.Window()
    window.walls, window.units = list(walls), [4] * len(walls)
    return dict(events=events, unit="jets", units=4, calls=1, window=window)


def test_flag_reads_per_jet_and_the_idle_they_hold(monkeypatch):
    rec = jet_spans(monkeypatch)
    assert reader("flag_reads_per_jet.sf").read(rec) == 3 / 4
    # 12 + 0 + 2 ms idle inside the reads; at the untraced pace the call
    # takes 157 ms, of which 157 - 87 = 70 ms idle
    assert reader("flag_read_idle_pct.sf").read(rec) == \
        pytest.approx(100 * 14 / 70)
    assert reader("init_idle_s_per_final.dt").read(rec) is None
    # no untraced call after the traced one: no pace to read the idle at
    rec = jet_spans(monkeypatch, walls=(0.5,))
    assert reader("flag_reads_per_jet.sf").read(rec) == 3 / 4
    assert reader("flag_read_idle_pct.sf").read(rec) is None
