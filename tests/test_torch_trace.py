"""The port's spans and counters (``nextou_tpu_torch/trace.py``) on the CPU:
off without a profiler (nothing recorded, no profiler range, no CUDA
event, no autograd node), and under ``torch.profiler`` the train step's
phases, the BTI map and each grapher block's forward and backward where
the profiler itself saw them."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nextou_tpu_torch import losses as pl
from nextou_tpu_torch import trace
from nextou_tpu_torch import train as pt
from nextou_tpu_torch.models import NexToU
from nextou_tpu_torch.models.nextou import GNNBlocks
from nextou_tpu_torch.models.spec import build_model_spec


def _tiny_spec(deep_supervision=True):
    """A five-stage 3D NexToU (one conv stage, four hybrid ones): 14
    [grapher, FFN] blocks."""
    return build_model_spec(
        in_channels=1, patch_size=(8, 16, 16), n_stages=5,
        features_per_stage=[4, 6, 6, 6, 6], kernel_sizes=[(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1), (1, 1, 1)],
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4,
        num_classes=3, deep_supervision=deep_supervision,
    )


def _step_and_batches(remat, n_batches=2):
    spec = _tiny_spec()
    torch.manual_seed(0)
    model = NexToU(spec, remat=remat)
    opt = pt.make_optimizer(pt.poly_lr(initial_lr=1e-2, max_steps=100, exponent=0.9,
                                       steps_per_epoch=10))
    state = pt.create_train_state(model, opt, 0)
    loss = pl.CompoundLossSpec(weight_ti=1e-4, ti=pl.TILossSpec.create(3, 26, [], [[1, 2]]))
    weights = pl.deep_supervision_weights(len(spec.decoder))
    step = pt.make_train_step(model, opt, loss, weights)
    rng = np.random.default_rng(1)
    batches = [{"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
                "seg": rng.integers(0, 3, (2, *spec.patch_size)).astype(np.int32)}
               for _ in range(n_batches)]
    return model, state, step, batches, weights


def test_off_records_nothing_and_adds_nothing(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("before", unit=True):
            pass
    recorded = len(trace.session()["spans"])
    calls = []
    monkeypatch.setattr(trace, "_range", lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: calls.append("event"))
    assert not trace.on()
    assert trace.span("a") is trace.span("b", unit=True)
    x = torch.ones(3, requires_grad=True)
    with trace.span("a", unit=True):
        with trace.span("b"):
            y = x * 2
    assert type(y.grad_fn) is type((x * 2).grad_fn)
    # a whole train step, graphers and BTI term included
    model, state, step, batches, _ = _step_and_batches(False, 1)
    out = model(torch.from_numpy(batches[0]["data"]))[0]
    names = set()
    fns = [out.grad_fn]
    while fns:
        fn = fns.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            fns += [f for f, _ in fn.next_functions]
    assert not any("InBackward" in n for n in names)
    step(state, batches[0])
    assert calls == [] and len(trace.session()["spans"]) == recorded


def test_nested_spans_record_parent_unit_and_thread():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        for _ in range(2):
            with trace.span("unit", unit=True):
                with trace.span("outer"):
                    with trace.span("inner"):
                        torch.ones(4).sum()
                # a thread with no open span of its own (as autograd's device
                # thread) hangs its spans under the unit's innermost one
                with trace.span("waiting"):
                    t = threading.Thread(target=lambda: trace._Span("other", False).__enter__()
                                         .__exit__(None, None, None))
                    t.start()
                    t.join(timeout=10)
                    assert not t.is_alive()
        with trace.span("outside"):
            pass
    spans = trace.session()["spans"]
    names = [s["name"] for s in spans]
    assert names == ["unit", "outer", "inner", "waiting", "other"] * 2 + ["outside"]
    me = threading.get_ident()
    for u in range(2):
        unit, outer, inner, waiting, other = spans[5 * u:5 * u + 5]
        assert unit["root"] and unit["parent"] is None and unit["unit"] == u
        assert outer["parent"] == 5 * u and inner["parent"] == 5 * u + 1
        assert waiting["parent"] == 5 * u and other["parent"] == 5 * u + 3
        assert {s["unit"] for s in (outer, inner, waiting, other)} == {u}
        assert {s["thread"] for s in (unit, outer, inner, waiting)} == {me} != {other["thread"]}
        assert unit["start_ns"] <= outer["start_ns"] <= inner["start_ns"]
        assert inner["end_ns"] <= outer["end_ns"] <= unit["end_ns"]
        assert unit["device_ms"] is None and unit["host_ms"] > 0
    assert spans[-1]["unit"] is None and spans[-1]["parent"] is None


def test_a_new_session_replaces_the_last_and_counts_over_it():
    trace.count("test.before", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("first"):
            trace.count("test.during", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("second"):
            trace.count("test.during", 3)
    trace.count("test.during", 100)  # after the session: not in it
    got = trace.session()
    assert [s["name"] for s in got["spans"]] == ["second"]
    assert got["counters"]["test.during"] == 3 and got["counters"].get("test.before", 0) == 0
    assert trace.counters()["test.during"] >= 105


def test_host_start_matches_the_profilers_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with trace.span(f"timed{i}"):
                torch.ones(64).sum()
    spans = {s["name"]: s for s in trace.session()["spans"]}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("timed")}
    assert set(events) == set(spans)
    for name, s in spans.items():
        # a host operation: a user annotation would get a device-side range too
        assert events[name].activity_type() == "cpu_op", name
        assert abs(events[name].start_ns() - s["start_ns"]) < 1e6, name
        assert abs(events[name].end_ns() - s["end_ns"]) < 1e6, name


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_phases_and_grapher_blocks(remat):
    model, state, step, batches, weights = _step_and_batches(remat)
    step(state, batches[0])  # outside the session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            state, _ = step(state, b)
    spans = trace.session()["spans"]
    roots = [i for i, s in enumerate(spans) if s["root"]]
    assert [spans[i]["name"] for i in roots] == ["train.step"] * len(batches)
    assert [spans[i]["unit"] for i in roots] == list(range(len(batches)))

    def children(i):
        return [j for j, s in enumerate(spans) if s["parent"] == i]

    heads = int(np.sum(np.asarray(weights) > 0))
    for r in roots:
        kids = [spans[j]["name"] for j in children(r)]
        assert kids == ["train.upload", "train.forward", "train.loss", "train.backward",
                        "train.optimizer"]
        loss = next(j for j in children(r) if spans[j]["name"] == "train.loss")
        assert [spans[j]["name"] for j in children(loss)] == ["loss.bti_map"] * heads
        assert all(spans[j]["unit"] == spans[r]["unit"] for j in range(len(spans))
                   if spans[j]["unit"] is not None and j > r and spans[j]["start_ns"]
                   < spans[r]["end_ns"])

    blocks = {m.span_name for m in model.modules() if isinstance(m, GNNBlocks)}
    assert len(blocks) == 14 and blocks == {s["name"] for s in spans if s["name"].startswith("gnn.")}
    ev = list(prof.profiler.kineto_results.events())
    for r in roots:
        fwd = next(j for j in children(r) if spans[j]["name"] == "train.forward")
        bwd = next(j for j in children(r) if spans[j]["name"] == "train.backward")
        for name in blocks:
            mine = [s for j, s in enumerate(spans) if s["name"] == name
                    and spans[r]["start_ns"] <= s["start_ns"] <= spans[r]["end_ns"]]
            # forward (under the model's forward), then recompute (with remat)
            # and backward (under the backward)
            under = [s["parent"] for s in mine]
            assert under.count(fwd) == 1 and under.count(bwd) == (2 if remat else 1), name
            f = next(s for s in mine if s["parent"] == fwd)
            b = mine[-1]
            seqs = {e.sequence_nr() for e in ev
                    if e.sequence_nr() >= 0 and "InBackward" not in e.name()
                    and f["start_ns"] <= e.start_ns() and e.end_ns() <= f["end_ns"]}
            assert seqs, name
            grads = [e for e in ev if e.name().startswith("autograd::engine::evaluate_function")
                     and e.sequence_nr() in seqs and "InBackward" not in e.name()]
            assert grads, name
            for e in grads:
                assert b["start_ns"] <= e.start_ns() and e.end_ns() <= b["end_ns"], (name, e.name())


@pytest.mark.gpu
def test_spans_on_the_card():
    """On the card a block's backward runs on autograd's device thread: its
    span still hangs under ``train.backward``; every span reads device ms
    from its CUDA events and none shows as device activity in the profile;
    a served case holds its tile batches' spans."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA events and autograd's device thread need a CUDA card")
    from nextou_tpu_torch import predict

    spec = _tiny_spec()
    torch.manual_seed(0)
    model = NexToU(spec, device="cuda")
    opt = pt.make_optimizer(pt.poly_lr(initial_lr=1e-2, max_steps=100, exponent=0.9,
                                       steps_per_epoch=10))
    state = pt.create_train_state(model, opt, 0)
    loss = pl.CompoundLossSpec(weight_ti=1e-4, ti=pl.TILossSpec.create(3, 26, [], [[1, 2]]))
    step = pt.make_train_step(model, opt, loss, pl.deep_supervision_weights(len(spec.decoder)))
    rng = np.random.default_rng(1)
    batch = {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
             "seg": rng.integers(0, 3, (2, *spec.patch_size)).astype(np.int32)}
    step(state, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
    spans = trace.session()["spans"]
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in spans)
    # the spans are host operations: none is device activity in the profile
    names = {s["name"] for s in spans}
    assert not [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.name in names]
    bwd = next(i for i, s in enumerate(spans) if s["name"] == "train.backward")
    main = spans[0]["thread"]
    blocks = {m.span_name for m in model.modules() if isinstance(m, GNNBlocks)}
    for name in blocks:
        mine = [s for s in spans if s["name"] == name]
        assert len(mine) == 2 and mine[1]["parent"] == bwd and mine[1]["thread"] != main, name

    served = NexToU(_tiny_spec(deep_supervision=False), device="cuda").eval()
    served.load_state_dict(model.state_dict())
    pred = predict.build_predictor(served, (0, 1, 2), tile_batch=2, output="seg")
    case = rng.standard_normal((12, 24, 20, 1)).astype(np.float32)
    pred(case)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pred(case)
    spans = trace.session()["spans"]
    names = [s["name"] for s in spans]
    assert spans[0]["name"] == "serve.case" and sum(s["root"] for s in spans) == 1
    tiles = names.count("serve.tile_predict")
    assert tiles >= 1 and names.count("serve.forward") == 4 * tiles
    assert names.count("serve.accumulate") == tiles
    assert all(s["unit"] == 0 and s["device_ms"] is not None for s in spans)
