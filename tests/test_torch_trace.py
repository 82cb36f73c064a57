"""The port's spans and counters (``ryolo_tpu_torch/utils/trace.py``) on the
CPU: off they are one shared no-op; on they nest, keep a stack per thread,
add up in ``summary()`` and clear on ``reset()``; under ``torch.profiler``
they are user annotations around the operators they issue, and the
benchmark's trace names an idle gap by the innermost one.  ``Detect.infer``,
``Trainer.train_step_rendered`` and the loader's overflow fallback open
the spans and counts that the benchmark's per-layer metrics read, and those
readers read them."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ryolo_tpu_torch.utils import trace
from tests.test_device_augment import HYP
from tests.test_torch_data import S, synth  # noqa: F401
from tests.torch_parity import MODEL_CFG, NC

CPU = torch.device("cpu")


@pytest.fixture
def spans_on():
    trace.reset()
    trace.enable(True)
    yield
    trace.enable(False)
    trace.reset()


def _spans():
    return trace.summary()["spans"]


def test_off_is_the_shared_no_op(monkeypatch):
    trace.enable(False)
    trace.reset()

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered while off")
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    a, b = trace.span("a", CPU), trace.span("b")
    assert a is b is trace._NOOP
    with a as got, b:
        assert got is a
    trace.count("c", 2)
    s = trace.summary()
    assert s["spans"] == {} and s["counters"]["c"] == 2


def test_no_annotation_without_a_profiler(spans_on, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    with trace.span("a", CPU):
        pass
    assert _spans()["a"]["count"] == 1


def test_nested_spans_share_the_sequence_and_nest(spans_on):
    with trace.span("outer", CPU) as outer:
        with trace.span("inner", CPU) as inner:
            trace.count("n", 3)
        with trace.span("inner", CPU) as again:
            pass
    with trace.span("outer", CPU) as second:
        pass
    assert outer.parent is None and inner.parent is outer
    assert again.parent is outer and second.parent is None
    assert inner.seq == again.seq == outer.seq != second.seq
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= again.start_ns <= again.end_ns <= outer.end_ns
    s = _spans()
    assert s["outer"]["count"] == 2 and s["inner"]["count"] == 2
    assert s["outer"]["counts"] == {"n": 3} == s["inner"]["counts"]
    children = (inner.end_ns - inner.start_ns) + (again.end_ns
                                                  - again.start_ns)
    own = (outer.end_ns - outer.start_ns) - children \
        + (second.end_ns - second.start_ns)
    assert s["outer"]["self_s"] == pytest.approx(own * 1e-9, abs=1e-12)
    assert s["inner"]["self_s"] == s["inner"]["host_s"]
    assert s["outer"]["host_s"] >= s["inner"]["host_s"]
    # a CPU device's time is its host time; a host-only span has none
    assert s["outer"]["device_s"] == pytest.approx(s["outer"]["host_s"],
                                                   rel=1e-12)
    with trace.span("host only"):
        pass
    assert _spans()["host only"]["device_s"] is None


def test_reset_clears_spans_and_counters(spans_on):
    from ryolo_tpu_torch.ops import cuda_nms

    with trace.span("a", CPU):
        trace.count("b")
    cuda_nms.LAUNCHES["nms_mask"] += 1
    assert trace.summary()["counters"]["launch.nms_mask"] >= 1
    trace.reset()
    s = trace.summary()
    assert s["spans"] == {} and "b" not in s["counters"]
    assert cuda_nms.LAUNCHES == {"nms_mask": 0, "nms_scan": 0}
    assert s["counters"]["launch.nms_mask"] == 0


def test_groups_are_the_modules_own_dicts():
    from ryolo_tpu_torch.ops import (cuda_iou, cuda_nms, cuda_render,
                                     cuda_warp, int8_conv)
    from ryolo_tpu_torch.parallel import COLLECTIVES

    counters = trace.summary()["counters"]
    for mod in (cuda_iou, cuda_nms, cuda_render, cuda_warp, int8_conv):
        for k, v in mod.LAUNCHES.items():
            assert counters[f"launch.{k}"] == v
        assert any(mod.LAUNCHES is d for d in trace._GROUPS["launch"])
    assert trace._GROUPS["collective"] == [COLLECTIVES]
    assert set(COLLECTIVES) == {"bn", "loss", "grad", "halo", "rows"}


def test_worker_threads_keep_their_own_stacks(spans_on):
    seen = {}

    def work():
        with trace.span("worker") as w:
            seen["w"] = w
    with trace.span("main", CPU) as main:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["w"].parent is None and seen["w"].seq != main.seq
    assert _spans()["worker"]["count"] == 1


def test_threads_lose_no_span_or_count(spans_on):
    """More threads than cores, a short switch interval: every span and
    count folded from every thread."""
    n_threads, n = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with trace.span("t"):
                    trace.count("k")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = trace.summary()
    assert s["spans"]["t"]["count"] == n_threads * n
    assert s["spans"]["t"]["counts"] == {"k": n_threads * n}
    assert s["counters"]["k"] == n_threads * n


def test_once_opens_no_second_span_of_a_name(spans_on):
    with trace.span("step", CPU) as a:
        assert trace.span("step", CPU, once=True) is trace._NOOP
    with trace.span("step", CPU, once=True) as b:
        pass
    assert a.parent is None and b.parent is None
    assert _spans()["step"]["count"] == 2


def test_profiler_turns_spans_on_and_the_trace_names_gaps():
    """Without ``enable``, spans record while ``torch.profiler`` does, as
    user annotations enclosing the operators issued inside them; a gap
    between device operations whose middle falls in the inner span is
    named by it."""
    from h100_bench import harness

    trace.enable(False)
    trace.reset()
    x = torch.randn(64, 64)
    with harness.Trace(torch, CPU) as tr:
        with trace.span("outer", CPU):
            with trace.span("inner", CPU):
                x @ x
    assert trace.span("after") is trace._NOOP
    assert {k: v["count"] for k, v in _spans().items()} == {"inner": 1,
                                                            "outer": 1}
    notes = {e["name"]: e for e in tr.events
             if e.get("cat") == "user_annotation"}
    mm = next(e for e in tr.events
              if e.get("cat") == "cpu_op" and e["name"] == "aten::mm")
    for name in ("outer", "inner"):
        e = notes[name]
        assert e["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= e["ts"] \
            + e["dur"]
    inner = notes["inner"]
    a, b = inner["ts"], inner["ts"] + inner["dur"]
    tr.events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a - 1.0,
                   "dur": 1.0},
                  {"ph": "X", "cat": "kernel", "name": "k", "ts": b,
                   "dur": 1.0}]
    gaps = tr.reduce(1.0)["idle_gaps"]
    assert gaps[0][0].split("/")[0] == "inner", gaps
    trace.reset()


def test_a_card_span_under_the_profiler_takes_no_event(spans_on,
                                                       monkeypatch):
    """Inside a recording profiler a card's span records no CUDA event
    (the trace times the device) and has no device time; a span of the
    same name timed outside it leaves the name's device time unknown."""
    from h100_bench import harness

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event recorded under the profiler")
    monkeypatch.setattr(trace, "event", no_event)
    with harness.Trace(torch, CPU):
        with trace.span("card", "cuda:0"):
            pass
        with trace.span("cpu", CPU):
            pass
    s = _spans()
    assert s["card"]["count"] == 1 and s["card"]["device_s"] is None
    assert s["cpu"]["device_s"] == pytest.approx(s["cpu"]["host_s"])
    with trace.span("cpu", CPU):
        pass
    with trace.span("cpu"):
        pass
    assert _spans()["cpu"]["count"] == 3
    assert _spans()["cpu"]["device_s"] is None


@torch.no_grad()
def test_detect_infer_spans_and_stages(spans_on):
    from argparse import Namespace

    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference

    torch.manual_seed(0)
    model = fuse_for_inference(Yolo(NC, MODEL_CFG, mode="csl",
                                    ver="yolov7"), device=CPU)
    # 128 px: 1,008 candidates, above the post-process's small cap, so
    # the post-process reads the count on the host once
    images = np.random.default_rng(0).integers(0, 256, (1, 128, 128, 3),
                                               np.uint8)
    det = Detect(Namespace(conf_thres=0.5, nms_thres=0.2))
    stages = _Stages(CPU)
    fetched = trace.COUNTS["sync.fetch"]
    dets, valid = det.fetch(*det.infer(model, images, torch.float32, CPU,
                                       NC, stages))
    assert isinstance(dets, np.ndarray) and isinstance(valid, np.ndarray)
    assert len(stages.elapsed_ms()) == 3
    assert stages.elapsed_ms() is stages.elapsed_ms()
    s = _spans()
    # closing order
    assert list(s) == ["detect.upload", "detect.convert", "detect.model",
                       "detect.decode", "detect.host_read",
                       "detect.post_process", "detect.infer"]
    assert all(v["count"] == 1 for v in s.values())
    assert s["detect.infer"]["counts"] == {"sync.upload": 1,
                                           "sync.threshold_upload": 1,
                                           "sync.post_process_read": 1}
    # the fetch, outside every span: counted, not spanned
    assert trace.COUNTS["sync.fetch"] - fetched == 2
    forward = s["detect.convert"]["host_s"] + s["detect.model"]["host_s"]
    assert stages.elapsed_ms()[0] >= 1e3 * forward - 1e-9
    assert not hasattr(det, "batch_s") and not hasattr(det, "stage_ms")


@torch.no_grad()
@pytest.mark.parametrize("on", [False, True])
def test_detect_counts_whether_spans_are_on_or_off(on):
    """Counters are always on: the same counts a batch with spans off (no
    span recorded) as on."""
    from argparse import Namespace

    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference

    torch.manual_seed(0)
    model = fuse_for_inference(Yolo(NC, MODEL_CFG, mode="csl",
                                    ver="yolov7"), device=CPU)
    images = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3),
                                               np.uint8)
    det = Detect(Namespace(conf_thres=0.5, nms_thres=0.2))
    trace.reset()
    trace.enable(on)
    try:
        for _ in range(2):
            det.fetch(*det.infer(model, images, torch.float32, CPU, NC,
                                 _Stages(CPU)))
        s = trace.summary()
    finally:
        trace.enable(False)
        trace.reset()
    assert {k: v for k, v in s["counters"].items()
            if k.startswith("sync.")} == {"sync.upload": 2,
                                          "sync.threshold_upload": 2,
                                          "sync.post_process_read": 2,
                                          "sync.fetch": 4}
    assert (s["spans"]["detect.infer"]["count"] == 2) if on \
        else s["spans"] == {}


def _train_batch(root, **kw):
    from ryolo_tpu_torch.data.datasets import CustomDataset
    from ryolo_tpu_torch.data.loader import DataLoader

    ds = CustomDataset(os.path.join(root, "train"), ["a", "b"],
                       kw.pop("hyp", HYP), img_size=S, augment=True,
                       csl=True)
    if kw.get("device_cache"):
        ds.build_tile_bank()
    loader = DataLoader(ds, batch_size=4, csl=True, device_augment=True,
                        max_targets=32, shuffle=True, **kw)
    it = iter(loader)
    try:
        return ds, next(it)
    finally:
        it.close()


def test_train_step_rendered_spans(synth, spans_on):  # noqa: F811
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import Trainer
    from ryolo_tpu_torch.train.trainer import csl_loss_fn

    _, batch = _train_batch(synth, seed=3)
    trace.reset()
    torch.manual_seed(0)
    model = Yolo(NC, MODEL_CFG, mode="csl", ver="yolov7")
    trainer = Trainer(model, csl_loss_fn(model.anchors, NC, HYP, CPU),
                      "SGD", 0.01)
    loss, _ = trainer.train_step_rendered(batch, None, 0.01, 1, 4)
    assert torch.isfinite(loss)
    s = _spans()
    children = ["train.render", "train.targets", "train.forward",
                "train.loss", "train.backward", "train.update"]
    assert list(s) == children + ["train.step"]
    assert all(v["count"] == 1 for v in s.values())
    total = sum(s[k]["device_s"] for k in children)
    assert total <= s["train.step"]["device_s"]
    assert s["train.step"]["self_s"] == pytest.approx(
        s["train.step"]["host_s"] - sum(s[k]["host_s"] for k in children),
        abs=1e-9)
    # the pixel path: train_step alone opens the step
    trace.reset()
    images = torch.zeros(4, 3, S, S)
    trainer.train_step({"images": images,
                        "tgt": torch.from_numpy(batch["tgt"]),
                        "tgt_csl": torch.from_numpy(batch["tgt_csl"]),
                        "tgt_mask": torch.from_numpy(batch["tgt_mask"])},
                       0.01, 2)
    assert list(_spans()) == ["train.forward", "train.loss",
                              "train.backward", "train.step"]


def test_overflow_fallback_is_spanned_and_counted(synth, spans_on):  # noqa: F811
    """The overflow fixture of ``test_torch_data.py``: mixup 1.0 on a
    banked loader falls back to pixel specs once, inside the collate, on
    the main thread (the worker threads open no span)."""
    _, batch = _train_batch(synth, hyp=dict(HYP, mixup=1.0), seed=13,
                            device_cache=True)
    assert "spec_tiles" in batch
    s = trace.summary()["spans"]
    assert set(s) == {"loader.wait", "loader.collate", "loader.fallback"}
    assert all(v["count"] == 1 and v["device_s"] is None
               for v in s.values())
    assert s["loader.fallback"]["host_s"] <= s["loader.collate"]["host_s"]
    assert s["loader.collate"]["self_s"] == pytest.approx(
        s["loader.collate"]["host_s"] - s["loader.fallback"]["host_s"],
        abs=1e-9)


# the benchmark's readers of the spans: a record with ``spans`` as the
# port's summary gives them, and what each reads from it
_DETECT = {"detect.infer": {"count": 4, "host_s": 0.1, "self_s": 0.0,
                            "device_s": 0.08,
                            "counts": {"sync.upload": 4,
                                       "sync.post_process_read": 4,
                                       "upload.h2d": 12}},
           "detect.upload": {"count": 4, "host_s": 0.01, "self_s": 0.01,
                             "device_s": 0.009, "counts": {}},
           "detect.convert": {"count": 4, "host_s": 0.001, "self_s": 0.001,
                              "device_s": 0.012, "counts": {}},
           "detect.model": {"count": 4, "host_s": 0.03, "self_s": 0.03,
                            "device_s": 0.04, "counts": {}},
           "detect.host_read": {"count": 4, "host_s": 0.02, "self_s": 0.02,
                                "device_s": 0.0001, "counts": {}}}
_TRAIN = {"train.step": {"count": 10, "host_s": 1.0, "self_s": 0.0,
                         "device_s": 2.0, "counts": {}},
          "train.render": {"count": 10, "host_s": 0.01, "self_s": 0.01,
                           "device_s": 0.003, "counts": {}},
          "train.forward": {"count": 10, "host_s": 0.3, "self_s": 0.3,
                            "device_s": 0.6, "counts": {}},
          "train.backward": {"count": 10, "host_s": 0.2, "self_s": 0.2,
                             "device_s": 1.2, "counts": {}},
          "loader.wait": {"count": 10, "host_s": 0.04, "self_s": 0.04,
                          "device_s": None, "counts": {}}}
READS = {"detect.syncs": ("detect", 2.0),
         "detect.uploads": ("detect", 3.0),
         "train.loader_workers_ms": ("train", 4.0)}


@pytest.mark.parametrize("metric", sorted(READS))
def test_span_readers(metric):
    from h100_bench import harness

    read = harness.load_reader(metric)
    kind, want = READS[metric]
    spans = _DETECT if kind == "detect" else _TRAIN
    assert read({"kind": kind, "spans": spans, "counters": {}}) == \
        pytest.approx(want)
    # an untraced run has no spans; another kind's record is not read
    assert read({"kind": kind, "batches": 4, "steps": 10}) is None
    other = "train" if kind == "detect" else "detect"
    assert read({"kind": other, "spans": spans, "counters": {}}) is None
    assert read({"kind": kind, "spans": {}, "counters": {}}) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_readers_take_the_ports_own_summary_in_a_traced_run(metric,
                                                           spans_on):
    """A traced record without ``spans`` is read from the port's summary,
    and left as it was; an untraced one is not read."""
    from h100_bench import harness

    kind, _ = READS[metric]
    top = "detect.infer" if kind == "detect" else "train.step"
    for _ in range(2):
        with trace.span(top, CPU):
            trace.count("sync.upload")
            trace.count("upload.h2d", 3)
            with trace.span("loader.wait"):
                time.sleep(1e-3)
    spans = trace.summary()["spans"]
    record = {"kind": kind, "trace": {"busy_s": 0.0}}
    want = {"detect.syncs": 1.0, "detect.uploads": 3.0,
            "train.loader_workers_ms":
                1e3 * spans["loader.wait"]["host_s"] / 2}[metric]
    read = harness.load_reader(metric)
    assert read(record) == pytest.approx(want)
    assert record == {"kind": kind, "trace": {"busy_s": 0.0}}
    assert read({"kind": kind}) is None


def test_a_port_without_spans_reads_nothing(monkeypatch):
    """The parent's program has no trace module: a traced record reads
    nothing, and raises nothing."""
    from h100_bench import harness

    monkeypatch.delitem(sys.modules, "ryolo_tpu_torch.utils.trace")
    for metric, (kind, _) in READS.items():
        assert harness.load_reader(metric)(
            {"kind": kind, "trace": {"busy_s": 0.0}}) is None
