"""The port's span and counter recorder (``utils/logging.py``) on the CPU.

- off (the default) it records nothing, hands out one shared no-op and
  never opens a ``record_function``, even under a running profiler;
- on, spans nest with their parents on each thread, and a train batch's
  request id is shared by the loader thread that built it, the
  consumer's wait for it and the step that ran on it (on the card also
  the producer's pinning and copying: marked ``cuda``, it skips here);
  counters add up by request;
- a tiny teacher's serving call and train step, and a tiny CLAT
  student's step, record the spans of their layers, and under a profiler
  each span also lies in its trace as ``mml.<name>``;
- a ``torch.export`` of the serving forward with the recorder on, under a
  profiler, is the one made with it off, with no profiler op.
"""
import threading

import numpy as np
import pytest
import torch

from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.data.pipeline import (Loader,
                                                         PathomicDataset,
                                                         PrefetchLoader)
from multimodal_learning_tpu_torch.eval.metrics import one_hot
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.serve import export_infer, make_infer_fn
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.steps import (
    build_teacher_train_step, init_teacher_state)
from multimodal_learning_tpu_torch.train.student import (freeze_teacher,
                                                         init_student_state)
from multimodal_learning_tpu_torch.train.student_clat import (
    build_clat_student_step)
from multimodal_learning_tpu_torch.utils import logging as rec

SIZE = 32
TINY = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=8,
            omic_dim=8, mmhid=8, feat_dim=8, batch_size=4, CRD_distill=1,
            pred_distill=1, nce_k=6, nce_p=1, pos_mode="exact", n_data=16,
            reg_type="none", niter=0, niter_decay=1, pallas_fusion="train",
            dropout_rate=0.0, host_workers=2)
MODEL_SPANS = {"path_net", "omic_net", "fusion", "classifier"}
STEP_SPANS = {"step.augment", "step.forward", "step.losses", "step.backward",
              "step.optimizer"}


@pytest.fixture
def recording():
    """The recorder on for the test; off again, and emptied, after it."""
    rec.enable()
    yield
    rec.collect()


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.normal(size=(n, 80)).astype(np.float32))


def _teacher(**kw):
    opt = Options(**dict(TINY, **kw))
    return opt, define_model(opt, generator=torch.Generator().manual_seed(4))


def _train_batch(opt, seed=0):
    rng = np.random.default_rng(seed)
    index = rng.permutation(opt.n_data)[:opt.batch_size]
    sample_idx = rng.integers(0, opt.n_data, (opt.batch_size, 1 + opt.nce_k))
    sample_idx[:, 0] = index
    return {k: torch.from_numpy(v) for k, v in {
        "omic": rng.normal(size=(opt.batch_size, 80)).astype(np.float32),
        "g": rng.integers(0, 3, opt.batch_size).astype(np.int32),
        "index": index.astype(np.int32),
        "sample_idx": sample_idx.astype(np.int32),
        "path_views": rng.integers(0, 256, (opt.batch_size, 2, SIZE, SIZE, 3),
                                   dtype=np.uint8)}.items()}


def _total(got, name):
    return sum(n for (k, _), n in got.counts.items() if k == name)


def _paths(spans):
    """Each span's name with the names of the spans it lies in, as
    ``outer/inner``."""
    by = {s.sid: s for s in spans}

    def path(s):
        return s.name if s.parent is None else f"{path(by[s.parent])}/{s.name}"
    return {path(s) for s in spans}


def test_off_records_nothing_and_never_calls_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    opt, model = _teacher()
    infer = make_infer_fn(opt, model)
    step = build_teacher_train_step(opt)
    state = init_teacher_state(opt, model, make_lr_schedule(opt, 4),
                               opt.n_data, seed=1, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        infer(*_inputs(2))
        step(state, _train_batch(opt), 0.1)
        rec.count("anything", 3)
    assert rec.span("a") is rec.span("b")
    assert rec.new_request() is None and rec.bound() is None
    got = rec.collect()
    assert got.spans == [] and got.counts == {}


def _two_batches(device):
    """Two batches of a tiny dataset through the ``PrefetchLoader`` onto
    ``device``, each under a fake step's spans; what was recorded."""
    opt = Options(**dict(TINY, input_size_path=16))
    rng = np.random.default_rng(0)
    data = {"train": {
        "x_path": list(rng.integers(0, 256, (8, 20, 20, 3), dtype=np.uint8)),
        "x_omic": rng.normal(size=(8, 80)).astype(np.float32),
        "e": np.ones(8, np.float32), "t": np.ones(8, np.float32),
        "g": rng.integers(0, 3, 8)}}
    loader = Loader(PathomicDataset(opt, data, "train", train=True),
                    batch_size=4, shuffle=True, drop_last=True, n_views=2,
                    workers=2, seed=0)
    try:
        for batch in PrefetchLoader(loader, depth=1, device=device):
            with rec.span("step.forward"):
                with rec.span("path_net"):
                    assert batch["omic"].device.type == torch.device(
                        device).type
                    batch["omic"].sum()
    finally:
        loader.close()
    return rec.collect()


def test_spans_nest_and_a_batch_shares_its_id_across_threads(recording):
    """Two batches through the loader's producer thread and two fake steps
    on this thread: the crops and stacking of a batch, the wait for it and
    the step on it have one request id; each span's parent is the span
    its own thread was inside."""
    got = _two_batches("cpu")
    me = threading.get_ident()
    steps = [s for s in got.spans if s.name == "step.forward"]
    assert len(steps) == 2 and {s.thread for s in steps} == {me}
    assert len({s.rid for s in steps}) == 2 and None not in {
        s.rid for s in steps}
    for st in steps:
        of = {s.name: s for s in got.spans if s.rid == st.rid}
        assert set(of) == {"loader.crops", "loader.stack", "prefetch.wait",
                           "step.forward", "path_net"}
        assert of["loader.crops"].thread == of["loader.stack"].thread != me
        assert of["prefetch.wait"].thread == me
        assert of["path_net"].parent == st.sid and st.parent is None
        assert of["loader.crops"].end_ns <= of["prefetch.wait"].end_ns
        assert of["prefetch.wait"].end_ns <= st.start_ns
    for s in got.spans:
        assert s.start_ns <= s.end_ns and s.traced is False
    assert {k for k, _ in got.counts} == {"prefetch.gets", "prefetch.ready"}
    assert _total(got, "prefetch.gets") == 2
    assert got.counts[("prefetch.gets", steps[0].rid)] == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prefetcher pins and copies "
                    "only for a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_prefetcher_on_the_card_records_pinning_and_copying(cuda,
                                                                recording):
    got = _two_batches(cuda)
    steps = [s for s in got.spans if s.name == "step.forward"]
    assert len(steps) == 2
    for st in steps:
        of = {s.name: s for s in got.spans if s.rid == st.rid}
        assert set(of) == {"loader.crops", "loader.stack", "prefetch.pin",
                           "prefetch.copy", "prefetch.wait", "step.forward",
                           "path_net"}
        producer = of["loader.crops"].thread
        assert of["prefetch.pin"].thread == of["prefetch.copy"].thread \
            == producer != st.thread
        assert of["prefetch.pin"].end_ns <= of["prefetch.copy"].start_ns
    assert _total(got, "prefetch.gets") == 2


def test_counters_add_up_by_request(recording):
    rid = rec.new_request()
    rec.count("n", 2)
    rec.count("n", 3)

    def other():
        rec.new_request()
        rec.count("n", 5)

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    rec.count("m")
    got = rec.collect()
    assert got.counts[("n", rid)] == 5 and _total(got, "n") == 10
    assert _total(got, "m") == 1 and rec.bound() is None


def test_teacher_serving_call_and_step_record_their_layers(recording):
    opt, model = _teacher()
    infer = make_infer_fn(opt, model)
    xp, xo = _inputs(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        infer(xp, xo)
    serve = rec.collect()
    assert _paths(serve.spans) == {
        "serve.infer", "serve.infer/serve.copy_in",
        "serve.infer/serve.forward",
        *(f"serve.infer/serve.forward/{n}" for n in MODEL_SPANS)}
    assert len({s.rid for s in serve.spans}) == 1
    assert all(s.traced for s in serve.spans)
    assert serve.counts == {("serve.copy_in_bytes", serve.spans[0].rid):
                            xp.nbytes + xo.nbytes}
    traced = [e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith(rec.PREFIX)]
    assert sorted(traced) == sorted(rec.PREFIX + s.name
                                    for s in serve.spans)

    rec.enable()
    step = build_teacher_train_step(opt)
    state = init_teacher_state(opt, model, make_lr_schedule(opt, 4),
                               opt.n_data, seed=1, device="cpu")
    step(state, _train_batch(opt), 0.1)
    got = rec.collect()
    names = [s.name for s in got.spans]
    assert set(names) == STEP_SPANS | MODEL_SPANS | {
        "contrast.scores", "contrast.bank_update"}
    assert names.count("step.optimizer") == 2       # zero_grad; Adam, EMA
    assert names.count("path_net") == 2             # the model and the EMA
    paths = _paths(got.spans)
    assert {"step.forward/fusion", "step.losses/contrast.scores",
            "step.losses/contrast.bank_update"} <= paths


def test_clat_student_step_records_contrast_and_gk_refine(recording):
    opt = Options(**dict(TINY, distill="crd", num_teachers=2,
                         pos_extra="neighbors", nce_p=2, assign_weights=True,
                         loss_weighting="GK_refine", use_grads_thresh=True,
                         grads_thresh=0.25))
    gen = torch.Generator().manual_seed(0)
    teacher = freeze_teacher(define_model(opt, generator=gen), "cpu")
    state = init_student_state(opt, define_model(opt, path_only=True,
                                                 generator=gen),
                               make_lr_schedule(opt, 4), opt.n_data,
                               device="cpu")
    g = np.arange(opt.n_data) % 3
    step = build_clat_student_step(
        opt, teacher, torch.from_numpy(one_hot(g, 3).T))
    batch = _train_batch(opt)
    batch["g"] = torch.from_numpy(g[batch["index"].numpy()].astype(np.int32))
    step(state, batch, True)
    paths = _paths(rec.collect().spans)
    assert {f"step.losses/{n}" for n in (
        "contrast.scores", "contrast.bank_update", "gk_refine")} <= paths
    assert {f"step.forward/{n}" for n in MODEL_SPANS} <= paths  # the teacher
    assert {p.split("/")[0] for p in paths} == STEP_SPANS


def test_export_with_the_recorder_on_is_the_one_made_off():
    opt, model = _teacher()
    off, _ = export_infer(opt, model, 2)
    rec.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on, _ = export_infer(opt, model, 2)
    finally:
        got = rec.collect()
    assert on.graph_module.code == off.graph_module.code
    assert "profiler" not in on.graph_module.code
    assert not any(s.name in MODEL_SPANS for s in got.spans)
