"""The port's ``torch.export`` serving artifact (``serve/export.py``,
``serve/load.py``, ``cli.export_model``) on the CPU.

- the ``.pt2`` round trip equals the eager ``make_infer_fn`` bitwise, at a
  fixed batch and under a dynamic batch that serves 1, 3 and 8, unpaired
  (fp32) and paired (bf16);
- the registered ops stand in the exported graph: B2 (``mml::kron_fwd``)
  once, and B5 (``mml::conv3x3``) 4 times when paired; with the Kronecker
  wrapper's CUDA route forced on CPU tensors (its autograd function over
  the op) the export still takes a dynamic batch;
- a fresh interpreter loads and serves the artifact without importing the
  port's ``models``;
- the artifact agrees with the JAX package's ``export_infer`` /
  ``load_exported`` at the whole-model tolerance (rtol 2e-3 / atol 5e-4);
- ``--test_augment`` is refused, mmdynamics serves ``{"pred_fuse"}``
  alone, loading on another device type than the artifact's raises, and
  the loaded artifact refuses inputs of another shape.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.serve import export_infer as j_export_infer
from multimodal_learning_tpu.serve import load_exported as j_load_exported
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import (define_model,
                                                  flax_from_state_dict)
from multimodal_learning_tpu_torch.ops import kron_fusion
from multimodal_learning_tpu_torch.serve import (export_infer, load_exported,
                                                 make_infer_fn, manifest,
                                                 write_artifact)

SIZE = 32
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, label_dim=3, pallas_fusion="train")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(**kw):
    opt = Options(**dict(DIMS, **kw))
    model = define_model(opt, generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return opt, model


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.normal(size=(n, 80)).astype(np.float32))


def _write(tmp_path, opt, model, batch, name="m"):
    exported, outputs = export_infer(opt, model, batch)
    path = str(tmp_path / f"{name}.pt2")
    write_artifact(path, exported, manifest(opt, batch, outputs, "cpu"))
    return path, exported


def _ops(exported):
    """The registered ops' nodes of an exported graph, autocast regions
    included."""
    return sorted(str(n.target) for m in exported.graph_module.modules()
                  if hasattr(m, "graph") for n in m.graph.nodes
                  if str(n.target).startswith("mml."))


@pytest.mark.parametrize("paired", [False, True])
def test_artifact_round_trip_is_the_eager_forward(tmp_path, paired):
    kw = dict(paired_conv=True, compute_dtype="bfloat16") if paired else {}
    opt, model = _model(**kw)
    eager = make_infer_fn(opt, model)
    want_ops = ["mml.conv3x3.default"] * (4 if paired else 0) + [
        "mml.kron_fwd.default"]
    for batch, sizes in ((4, (4,)), ("dynamic", (1, 3, 8))):
        path, exported = _write(tmp_path, opt, model, batch)
        assert _ops(exported) == sorted(want_ops)
        man = json.load(open(path + ".json"))
        assert man["format"] == "torch.export" and man["platforms"] == ["cpu"]
        b = "b" if batch == "dynamic" else batch
        assert man["inputs"]["x_path"] == f"uint8[{b},{SIZE},{SIZE},3]"
        infer = load_exported(path, "cpu")
        for n in sizes:
            x_path, x_omic = _inputs(n, n)
            got, want = infer(x_path, x_omic), eager(x_path, x_omic)
            assert sorted(got) == man["outputs"] == sorted(want)
            for k in want:
                assert got[k].dtype == torch.float32
                assert torch.equal(got[k], want[k]), (batch, n, k)


def test_kernel_route_exports_with_a_dynamic_batch(tmp_path, monkeypatch):
    """The Kronecker wrapper's CUDA route (``_KronMatmul`` over the op)
    traced on CPU tensors: the op's CPU kernel computes, so the artifact
    still equals the eager plain forward bitwise."""
    opt, model = _model(paired_conv=True)
    eager = make_infer_fn(opt, model)
    x_path, x_omic = _inputs(5, 1)
    want = eager(x_path, x_omic)
    monkeypatch.setattr(kron_fusion, "_device_of", lambda what, *t: "cuda")
    path, exported = _write(tmp_path, opt, model, "dynamic")
    assert _ops(exported) == sorted(["mml.conv3x3.default"] * 4
                                    + ["mml.kron_fwd.default"])
    got = load_exported(path, "cpu")(x_path, x_omic)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_artifact_loads_without_the_model_code(tmp_path):
    opt, model = _model(paired_conv=True)
    path, _ = _write(tmp_path, opt, model, "dynamic")
    code = (
        "import sys, numpy as np\n"
        "from multimodal_learning_tpu_torch.serve import load_exported\n"
        f"out = load_exported({path!r}, 'cpu')(np.zeros((2, {SIZE}, {SIZE},"
        " 3), np.uint8), np.zeros((2, 80), np.float32))\n"
        "assert out['pred_fuse'].shape == (2, 3)\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('multimodal_learning_tpu_torch.models', 'jax', "
        "'multimodal_learning_tpu.'))]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_artifact_matches_jax_export(tmp_path):
    opt, model = _model()
    path, _ = _write(tmp_path, opt, model, "dynamic")
    params, stats = flax_from_state_dict(model.state_dict())
    jopt = JOptions(**DIMS)
    blob, outputs = j_export_infer(jopt, j_define(jopt), params, stats,
                                   "dynamic")
    x_path, x_omic = _inputs(3, 2)
    want = j_load_exported(blob)(jnp.asarray(x_path), jnp.asarray(x_omic))
    got = load_exported(path, "cpu")(x_path, x_omic)
    assert sorted(got) == sorted(outputs)
    for k in outputs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-3, atol=5e-4, err_msg=k)


def test_test_augment_is_refused():
    opt, model = _model(test_augment=True)
    with pytest.raises(ValueError, match="test_augment"):
        export_infer(opt, model, 4)
    with pytest.raises(ValueError, match="test_augment"):
        make_infer_fn(opt, model)


def test_mmdynamics_serves_pred_fuse_alone(tmp_path):
    opt, model = _model(fusion_type="mmdynamics", paired_conv=True)
    path, exported = _write(tmp_path, opt, model, 4)
    assert _ops(exported) == ["mml.conv3x3.default"] * 4
    assert json.load(open(path + ".json"))["outputs"] == ["pred_fuse"]
    x_path, x_omic = _inputs(4, 3)
    got = load_exported(path, "cpu")(x_path, x_omic)
    want = make_infer_fn(opt, model)(x_path, x_omic)
    assert set(got) == set(want) == {"pred_fuse"}
    assert torch.equal(got["pred_fuse"], want["pred_fuse"])


def test_loading_on_another_device_type_raises(tmp_path):
    opt, model = _model()
    path, _ = _write(tmp_path, opt, model, 4)
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not cuda"):
        load_exported(path, "cuda")
    man = json.load(open(path + ".json"))
    man["platforms"] = ["cuda"]
    with open(path + ".json", "w") as fh:
        json.dump(man, fh)
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not cpu"):
        load_exported(path, "cpu")


@pytest.mark.parametrize("batch", [4, "dynamic"])
def test_artifact_refuses_inputs_of_another_shape(tmp_path, batch):
    """The loaded artifact checks its inputs against the exported shapes:
    another image size, another batch than a fixed one, or two batches
    that differ raise before the graph runs."""
    opt, model = _model()
    infer = load_exported(_write(tmp_path, opt, model, batch)[0], "cpu")
    x_path, x_omic = _inputs(4)
    infer(x_path, x_omic)
    with pytest.raises(ValueError, match="the artifact takes"):
        infer(x_path[:, :16], x_omic)
    with pytest.raises(ValueError, match="the artifact takes"):
        infer(x_path[:3], x_omic[:3] if batch == 4 else x_omic)


@pytest.mark.parametrize("variant", ["A", "B"])
def test_trilinear_fusion_exports_with_a_dynamic_batch(variant):
    """``TrilinearFusion`` (no CLI serves it) forms its Kronecker product
    pairwise, so an export with a dynamic batch contracts in eager's order:
    the exported module equals the eager one bitwise at batches 1, 3 and
    8."""
    from multimodal_learning_tpu_torch.models.fusion import TrilinearFusion
    fusion = TrilinearFusion(variant, dim1=6, dim2=5, dim3=6, mmhid=7,
                             generator=torch.Generator().manual_seed(3))
    fusion.eval()
    rng = np.random.default_rng(7)
    vecs = [torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
            for n in (2, 3, 8) for d in (6, 5, 6)]
    batch = torch.export.Dim("b")
    with torch.no_grad():
        ep = torch.export.export(fusion, tuple(vecs[:3]),
                                 dynamic_shapes=[{0: batch}] * 3)
        for i in (0, 1, 2):
            args = vecs[3 * i:3 * i + 3] if i else [v[:1] for v in vecs[:3]]
            assert torch.equal(ep.module()(*args), fusion(*args)), i
