"""The readers of the program's spans on hand-built traces: only spans that
lie wholly inside the slice count, the expected ms come out, and a slice
without the spans, or with a dropped copy record, reads nothing."""

from pathlib import Path

import pytest

from benchmark import harness
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SLICE = ("bench.slice", 0.0, 10000.0)      # the window, in the trace's us


def read(metric, host, device=()):
    """``metric``'s reading of a slice over [0, 10000] us, and what it
    logged."""
    cell = harness.load_cell(ROOT, "coordgridnet_train_b32")
    said = []
    tr = Trace(wall_s=0.01, window=(0.0, 10000.0), device=list(device),
               host=[SLICE] + list(host))
    value = harness.reader(cell, metric).read({"trace": tr,
                                               "log": said.append})
    return value, said


def test_loader_host_ms_sums_its_parts_over_the_batches():
    host = [("loader.collate", -500.0, 300.0),     # crosses the start
            ("loader.pin", 300.0, 900.0),
            ("loader.copy", 900.0, 1000.0),
            ("loader.gather", 1000.0, 4000.0),     # a wait: not counted
            ("loader.collate", 4000.0, 6000.0),
            ("loader.pin", 6000.0, 7000.0),
            ("loader.copy", 7000.0, 7500.0),
            ("loader.collate", 9500.0, 10500.0)]   # crosses the end
    value, _ = read("loader_host_ms.train", host)
    assert value == pytest.approx((600 + 100 + 2000 + 1000 + 500) / 1e3 / 2)


def test_step_enqueue_ms_is_the_mean_whole_step():
    host = [("train.step", -100.0, 2000.0), ("train.step", 2500.0, 4500.0),
            ("step.forward", 2600.0, 3000.0), ("train.step", 5000.0, 9000.0),
            ("train.step", 9800.0, 10100.0)]
    value, _ = read("step_enqueue_ms.train", host)
    assert value == pytest.approx((2000 + 4000) / 2 / 1e3)


def test_fetch_ms_reads_the_copies_inside_fetches():
    host = [("serve.fetch", 1000.0, 3000.0), ("serve.fetch", 5000.0, 8000.0),
            ("serve.fetch", 9500.0, 10200.0)]
    device = [("Memcpy DtoH (Device -> Pageable)", 1100.0, 2900.0),
              ("Memcpy DtoH (Device -> Pageable)", 5100.0, 7600.0),
              ("Memcpy DtoH (Device -> Pageable)", 9600.0, 10100.0),
              ("Memcpy DtoH (Device -> Pageable)", 3500.0, 3600.0),
              ("Memcpy HtoD (Pageable -> Device)", 1200.0, 1300.0),
              ("conv3x3_mma_kernel", 5200.0, 5300.0)]
    value, _ = read("fetch_ms.rollout", host, device)
    assert value == pytest.approx((1800 + 2500) / 1e3 / 2)


def test_fetch_ms_reads_nothing_where_a_copy_record_was_dropped():
    host = [("serve.fetch", 1000.0, 3000.0), ("serve.fetch", 5000.0, 8000.0)]
    device = [("Memcpy DtoH (Device -> Pageable)", 1100.0, 2900.0),
              ("Memcpy DtoH (Device -> Pageable)", 3500.0, 3600.0)]
    value, said = read("fetch_ms.rollout", host, device)
    assert value is None and "1 Memcpy DtoH records in 2 fetches" in said[0]


def test_request_host_ms_sums_its_parts_over_the_requests():
    host = [("serve.request", 0.0, 4000.0), ("serve.pack", 0.0, 500.0),
            ("serve.upload", 500.0, 800.0), ("serve.rollout", 800.0, 2500.0),
            ("serve.fetch", 2500.0, 3800.0), ("serve.decode", 3800.0, 4000.0),
            ("serve.request", 5000.0, 9000.0), ("serve.pack", 5000.0, 5400.0),
            ("serve.upload", 5400.0, 5600.0),
            ("serve.decode", 8900.0, 9000.0),
            ("serve.request", 9500.0, 12000.0),
            ("serve.pack", 9500.0, 9900.0)]        # its request crosses
    value, _ = read("request_host_ms.rollout", host)
    assert value == pytest.approx(
        (500 + 300 + 200 + 400 + 200 + 100 + 400) / 1e3 / 2)


def test_frame_enqueue_ms_is_the_mean_whole_frame():
    host = [("rollout.frame", -50.0, 50.0), ("rollout.frame", 100.0, 600.0),
            ("rollout.step", 100.0, 400.0), ("rollout.frame", 600.0, 1300.0),
            ("rollout.frame", 9900.0, 10001.0)]
    value, _ = read("frame_enqueue_ms.latency", host)
    assert value == pytest.approx((500 + 700) / 2 / 1e3)


@pytest.mark.parametrize("metric,span", [
    ("loader_host_ms.train", "loader.copy"),
    ("step_enqueue_ms.train", "train.step"),
    ("fetch_ms.rollout", "serve.fetch"),
    ("request_host_ms.rollout", "serve.request"),
    ("frame_enqueue_ms.latency", "rollout.frame")])
def test_a_slice_without_its_spans_reads_nothing(metric, span):
    """The parent's program records no span: each reader reads nothing
    and says why, also where its span only crosses the slice's edge."""
    host = [("bench.request", 100.0, 900.0), ("aten::mm", 200.0, 300.0),
            (span, 9000.0, 11000.0)]
    device = [("Memcpy DtoH (Device -> Pageable)", 9500.0, 9600.0)]
    value, said = read(metric, host, device)
    assert value is None and span in said[0]
    assert read(metric, [])[0] is None


def test_the_readers_count_no_launches():
    """The drivers' retry compares a reader's ``COUNTERS`` with the launch
    counters: these readers add none."""
    cell = harness.load_cell(ROOT, "coordgridnet_train_b32")
    for m in ("loader_host_ms.train", "step_enqueue_ms.train",
              "fetch_ms.rollout", "request_host_ms.rollout",
              "frame_enqueue_ms.latency"):
        assert not hasattr(harness.reader(cell, m), "COUNTERS")
