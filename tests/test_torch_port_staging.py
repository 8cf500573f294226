"""The serving copy-in (``serve/staging.py``) on the CPU: the layout of its
buffer, the packing of the inputs into it and back out, and the direct path
a CPU model's inputs take.  The staged path (a pinned buffer, a CUDA event)
needs the card: ``test_torch_port_cuda.py`` holds it to ``torch.as_tensor``
there."""
import numpy as np
import pytest
import torch

from multimodal_learning_tpu_torch.serve.staging import (ALIGN, CopyIn, _at,
                                                         layout)
from multimodal_learning_tpu_torch.utils import logging as rec

CHUNK = 64 * 512 * 512 * 3          # a serve cell's chunk of patches


@pytest.mark.parametrize("sizes", [[], [0], [CHUNK, 64 * 80 * 4],
                                   [3 * 5 * 5 * 3, 3 * 80 * 4], [1, 0, 7]])
def test_layout_places_each_input_aligned_and_apart(sizes):
    offsets, total = layout(sizes)
    ends = [o + n for o, n in zip(offsets, sizes)]
    assert all(o % ALIGN == 0 for o in offsets)
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert total == (ends[-1] if sizes else 0)
    assert all(o - e < ALIGN for e, o in zip([0] + ends, offsets))


def _inputs(kind):
    g = torch.Generator().manual_seed(7)
    patches = torch.randint(0, 256, (5, 6, 6, 3), dtype=torch.uint8,
                            generator=g)
    omic = torch.randn(5, 80, generator=g)
    return {
        "chunk": [patches, omic],
        "odd_bytes": [patches[:, :5, :5], omic[:, :79]],
        "views": [patches[::2].permute(0, 2, 1, 3), omic[1::2, ::3]],
        "empty": [patches[:0], omic[:0]],
        "omic_only": [omic],
    }[kind]


@pytest.mark.parametrize("kind", ["chunk", "odd_bytes", "views", "empty",
                                  "omic_only"])
def test_inputs_packed_at_their_offsets_come_back_bitwise(kind):
    """What the card's path does with the pinned buffer and the device
    buffer, on plain CPU buffers: each input copied in at its offset of
    ``layout`` and read back out as a contiguous tensor of its own dtype
    and shape, the bytes between inputs left alone."""
    srcs = _inputs(kind)
    offsets, total = layout([s.nbytes for s in srcs])
    buf = torch.full((total + ALIGN,), 0xA5, dtype=torch.uint8)
    for s, off in zip(srcs, offsets):
        _at(buf, off, s).copy_(s)
    ends = [off + s.nbytes for s, off in zip(srcs, offsets)]
    for s, off in zip(srcs, offsets):
        got = _at(buf.clone(), off, s)
        assert got.is_contiguous() and got.dtype == s.dtype
        assert got.shape == s.shape and torch.equal(got, s)
    for e, o in zip(ends, offsets[1:] + [total + ALIGN]):
        assert bool((buf[e:o] == 0xA5).all())


@pytest.mark.parametrize("kind", ["numpy", "tensor", "view", "float64"])
def test_cpu_model_takes_its_inputs_as_torch_as_tensor(kind):
    """On the CPU both inputs are ``torch.as_tensor`` as before: a CPU
    tensor is the caller's own, the omic rows become float32, and the
    recorder counts nothing."""
    rng = np.random.default_rng(0)
    xp = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    xo = rng.normal(size=(3, 80)).astype(np.float32)
    if kind == "tensor":
        xp, xo = torch.from_numpy(xp), torch.from_numpy(xo)
    elif kind == "view":
        xp, xo = xp[::2, 1:7], xo[:, ::2]
    elif kind == "float64":
        xo = xo.astype(np.float64)
    copy_in = CopyIn("cpu")
    rec.enable()
    try:
        got_p, got_o = copy_in(xp, xo)
    finally:
        counts = rec.collect().counts
    assert counts == {}
    if kind == "tensor":
        assert got_p is xp and got_o is xo
    assert got_p.dtype == torch.uint8
    assert torch.equal(got_p, torch.as_tensor(xp))
    assert got_o.dtype == torch.float32
    assert torch.equal(got_o, torch.as_tensor(xo, dtype=torch.float32))
