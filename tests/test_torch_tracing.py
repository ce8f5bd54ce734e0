"""The engine's stage spans and its ``flagged`` counter
(``torchpiv_tpu_torch.utils.profiling``) on the CPU: tracing changes no
field; each stage span appears once a pass and nests under ``piv.call`` in
the profiler's events; a record's wall clock lies inside the profiler's own
event for the range; ``flagged`` is the packed result's invalid count; with
the profiler off nothing records; and the benchmark's stage readers return
None where no device time was recorded."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.pipeline import packed_forward
from torchpiv_tpu_torch.utils import profiling
from torchpiv_tpu_torch.utils.synthetic import particle_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (192, 192)
CONFIGS = {
    "cws2": dict(multipass=2),
    "def3": dict(multipass=3, multipass_mode="DEF"),
    "split2": dict(multipass=2, fused="split"),
}
# the stages each pass opens, pass 1 first, then every refine pass
PASS1 = {"cws2": ("windows", "correlate", "peakfit", "guard"),
         "def3": ("windows", "correlate", "peakfit", "guard"),
         "split2": ("windows", "correlate", "guard")}
REFINE = {"cws2": ("predict", "windows", "correlate", "peakfit", "guard"),
          "def3": ("predict", "windows", "correlate", "peakfit", "guard"),
          "split2": ("predict", "windows", "correlate", "guard")}
READERS = ("windows_ms_per_pair", "correlate_ms_per_pair", "peakfit_ms_per_pair",
           "fields_ms_per_pair", "flagged_vectors_pct")


def _engine(name):
    return MultipassPIV(PIVConfig(frame_shape=SHAPE, wind_size=64, overlap=32,
                                  **CONFIGS[name]), device="cpu")


def _frames(noisy=False):
    fa, fb = particle_pair(SHAPE, (2.3, -1.2), seed=3)
    if noisy:  # a decorrelated band: flagged vectors
        fb = fb.copy()
        fb[:64] = np.random.default_rng(5).uniform(0, 255, (64, SHAPE[1]))
    return (torch.from_numpy(np.stack([fa, fa[::-1].copy()])),
            torch.from_numpy(np.stack([fb, fb[::-1].copy()])))


def _expected(name, passes):
    names = ["piv.input"]
    for p in range(1, passes + 1):
        names += [f"piv.pass{p}.{s}" for s in (PASS1 if p == 1 else REFINE)[name]]
    return names + ["piv.post"]


def _traced(engine, a, b):
    """One engine call under the CPU profiler: its packed result, its
    record and the profiler's events ``name -> [(start_ns, end_ns)]``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        packed = packed_forward(engine, a, b)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("piv."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return packed, profiling.calls()[-1], events


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tracing_changes_no_field(name):
    engine = _engine(name)
    a, b = _frames()
    plain = packed_forward(engine, a, b)
    traced, rec, _ = _traced(engine, a, b)
    assert torch.equal(plain, traced)
    assert rec.pairs == 2 and rec.vectors == 2 * np.prod(engine.final_field_shape)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_span_names_nest_under_the_call(name):
    engine = _engine(name)
    _, rec, events = _traced(engine, *_frames())
    want = _expected(name, len(engine.schedule))
    assert [s.name for s in rec.spans] == want
    assert sorted(events) == sorted(want + [profiling.CALL])
    assert all(len(v) == 1 for v in events.values())
    (c0, c1), = events[profiling.CALL]
    for n in want:
        (s0, s1), = events[n]
        assert c0 <= s0 <= s1 <= c1, n
    assert all(s.parent == rec.id and s.device_ms is None for s in rec.spans)
    assert rec.call.parent is None and rec.call.device_ms is None


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_record_shares_the_profiler_clock(name):
    _, rec, events = _traced(_engine(name), *_frames())
    slack = 200_000  # 0.2 ms
    for s in [rec.call] + rec.spans:
        (e0, e1), = events[s.name]
        assert e0 - slack <= s.start_ns <= s.end_ns <= e1 + slack, s.name
        assert s.host_ms == pytest.approx((s.end_ns - s.start_ns) / 1e6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flagged_counts_the_packed_invalid(name):
    packed, rec, _ = _traced(_engine(name), *_frames(noisy=True))
    flagged = int((packed[:, 2] > 0.5).sum())
    assert flagged > 0
    assert rec.counts == {"flagged": flagged}


def test_flagged_is_zero_without_validation():
    engine = MultipassPIV(PIVConfig(frame_shape=SHAPE, wind_size=64, overlap=32,
                                    multipass=2, validate=False), device="cpu")
    _, rec, _ = _traced(engine, *_frames(noisy=True))
    assert rec.counts == {"flagged": 0}


def test_off_records_nothing(monkeypatch):
    engine = _engine("cws2")
    a, b = _frames()
    before = profiling.calls()

    def forbidden(*args, **kwargs):
        raise AssertionError("opened while the profiler is off")

    monkeypatch.setattr(profiling, "_range", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert profiling.span("piv.post") is profiling.OFF
    assert profiling.engine_call(torch.device("cpu"), 1, 1) is profiling.OFF
    packed_forward(engine, a, b)
    assert profiling.last_call() is None
    after = profiling.calls()
    assert [c.id for c in after] == [c.id for c in before]


def test_span_outside_a_call_is_a_range_only():
    n = len(profiling.calls())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("piv.pass1.windows"):
            torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "piv.pass1.windows" in names
    assert len(profiling.calls()) == n


def test_record_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_done", profiling.deque(maxlen=3))
    engine = _engine("split2")
    a, b = _frames()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            packed_forward(engine, a[:1], b[:1])
    ids = [c.id for c in profiling.calls()]
    assert len(ids) == 3 and ids == sorted(ids) and ids[-1] == profiling.last_call()


def test_offline_batches_name_their_call(tmp_path):
    """``OfflinePIV``'s engine runs on its feeder thread, which the
    profiler does not capture; its calls record all the same, and each
    batch's ``span_log`` entry names its call's record."""
    from torchpiv_tpu_torch import OfflinePIV
    from torchpiv_tpu_torch.io.decode import imwrite_gray

    for i in range(5):
        fa, fb = particle_pair(SHAPE, (2.3, -1.2), seed=30 + i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=4, wind_size=64,
                     overlap=32, multipass=2)
    plain = list(piv())
    piv.span_log = spans = []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = list(piv())
    for a, b in zip(traced, plain):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    calls = {c.id: c for c in profiling.calls()}
    assert [s["pairs"] for s in spans] == [4, 1]
    assert [calls[s["call"]].pairs for s in spans] == [4, 1]
    assert spans[0]["call"] < spans[1]["call"]


# a shrunk traced run of each cell in a fresh interpreter (the harness
# refuses a process that has loaded JAX), with the run's records captured
CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from portbench.lib import cell as cellmod, folder
from portbench.lib.stages import window_calls
from torchpiv_tpu_torch.utils import profiling

seen = []

class Captured(cellmod.Records):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        seen.append(self)

cellmod.Records = Captured
# names for five times the engine's timed pace: a loaded CPU's pace varies
# more than the card's, and a folder that runs dry raises
folder.LINK_MARGIN = 5.0
bench = json.load(open(sys.argv[1] + "/BENCHMARK.json"))
small = dict(frame_shape=(192, 192), unique_pairs=8, batch=4, check_pairs=3)
readers = json.loads(sys.argv[2])
out = {}
for w in bench["workloads"]:
    line = cellmod.run(w["name"], 2**31 + 101, 1.0, True, torch.device("cpu"),
                       time.perf_counter(), bench, shrink=small)
    rec = seen[-1]
    names = [m["name"] for m in cellmod.Cell(w["name"], bench).per_layer
             if m["name"].split(".")[0] in readers]
    calls = profiling.calls()
    ids = {s["call"] for s in rec.span_log or ()}
    out[w["name"]] = {
        "read": {n: cellmod.load_metric(n).read(rec) for n in names},
        "reported": sorted(set(names) & set(line["metrics"])),
        "window_calls": window_calls(rec),
        "records": len(calls),
        "device_ms": [c.call.device_ms for c in calls],
        "call_ids_known": ids <= {c.id for c in calls},
        "call_ids_none": None in ids,
    }
print(json.dumps(out))
"""


def test_readers_return_none_on_the_cpu(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", CHILD, ROOT, json.dumps(READERS)],
                          capture_output=True, text=True, timeout=600, env=env,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out) == 3
    for cell, got in out.items():
        assert len(got["read"]) == len(READERS), cell
        assert all(v is None for v in got["read"].values()), (cell, got["read"])
        assert got["reported"] == [] and got["window_calls"] is None
        # the records are there; they hold no device time
        assert got["records"] > 0 and set(got["device_ms"]) == {None}
        assert got["call_ids_known"] and not got["call_ids_none"]
