"""The port's serving path against the JAX package's.

``make_infer_fn`` on the same weights and uint8 inputs; a fold checkpoint
written by the JAX package, exported and served by the port's CLIs on the
CPU (``MML_PLATFORM=cpu``) and by the JAX package's CLIs; the checkpoint
layout both ways; the port importing no JAX; and the CLIs refusing to fall
back to the CPU unasked.  fp32 throughout, tolerance of
``test_torch_import.py``'s whole-model check (rtol 2e-3, atol 5e-4).
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.serve import make_infer_fn as j_make_infer_fn
from multimodal_learning_tpu.utils.checkpoint import (
    load_checkpoint as j_load_checkpoint, save_checkpoint as j_save_checkpoint)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import (define_model,
                                                  flax_from_state_dict,
                                                  state_dict_from_flax)
from multimodal_learning_tpu_torch.serve import make_infer_fn
from multimodal_learning_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                            save_checkpoint)

SIZE = 64
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, label_dim=3, batch_size=4,
            pallas_fusion="train")
TOL = dict(rtol=2e-3, atol=5e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_weights(opt, seed):
    """flax init of the JAX model with non-trivial BN statistics."""
    v = j_define(opt).init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed)},
        x_path=jnp.zeros((1, SIZE, SIZE, 3)),
        x_omic=jnp.zeros((1, opt.input_size_omic)), train=False)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if name == "['mean']":
            return rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)
        if name == "['var']":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map_with_path(leaf, v["batch_stats"]))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.normal(size=(n, 80)).astype(np.float32))


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_make_infer_fn_matches_jax():
    jopt = JOptions(**DIMS)
    params, stats = _jax_weights(jopt, 0)
    x_path, x_omic = _inputs(3, 1)
    want = jax.jit(j_make_infer_fn(jopt, j_define(jopt), params, stats))(
        x_path, x_omic)
    opt = Options(**DIMS)
    model = define_model(opt)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    got = make_infer_fn(opt, model)(x_path, x_omic)
    assert all(v.dtype == torch.float32 for v in got.values())
    _close({k: v.numpy() for k, v in got.items()}, want)


def _write_images(root, n, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n):  # lossless, slightly larger than SIZE: a real crop
        p = os.path.join(root, f"roi_{i}.png")
        Image.fromarray(rng.integers(0, 256, (SIZE + 10, SIZE + 6, 3),
                                     dtype=np.uint8)).save(p)
        files.append(p)
    return files


def test_jax_checkpoint_exported_and_served_by_port_cli(tmp_path,
                                                        monkeypatch):
    """JAX save_checkpoint -> port export_model -> port predict on the CPU
    matches the JAX package's export_model -> predict on the same files
    (5 images at a fixed batch of 4: the ragged tail is padded)."""
    from multimodal_learning_tpu.cli import export_model as j_export
    from multimodal_learning_tpu.cli import predict as j_predict
    from multimodal_learning_tpu_torch.cli import export_model, predict

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    root = str(tmp_path)
    jopt = JOptions(**DIMS, checkpoints_dir=root, exp_name="e",
                    model_name="m")
    params, stats = _jax_weights(jopt, 2)
    j_save_checkpoint(os.path.join(root, "e", "m", "m_1_best.pt"),
                      {"split": 1, "opt": jopt, "epoch": 1,
                       "model_state_dict": params, "batch_stats": stats,
                       "metrics": None})
    files = _write_images(root, 5, 3)
    omic = _inputs(5, 4)[1]
    csv = os.path.join(root, "omic.csv")
    np.savetxt(csv, omic, delimiter=",", comments="",
               header=",".join(f"g{j}" for j in range(80)))
    flags = ["--checkpoints_dir", root, "--exp_name", "e", "--model_name",
             "m", "--export_batch", "4"]

    written = export_model.main(flags)
    assert written == [os.path.join(root, "e", "m", "m_1.serve.pt")]
    man = json.load(open(written[0] + ".json"))
    assert man["format"] == "torch.save/state_dict"
    assert man["platforms"] == ["cuda", "cpu"]
    assert man["inputs"]["x_path"] == f"uint8[4,{SIZE},{SIZE},3]"
    assert man["outputs"] == sorted(["hazard_fuse", "hazard_path",
                                     "hazard_omic", "pred_fuse", "pred_path",
                                     "pred_omic"])
    out_pkl = os.path.join(root, "preds.pkl")
    got = predict.main(["--artifact", written[0], "--images", *files,
                        "--omic_csv", csv, "--out", out_pkl, "--quiet"])

    j_written = j_export.main(flags)
    want = j_predict.main(["--artifact", j_written[0], "--images", *files,
                           "--omic_csv", csv, "--quiet"])
    assert got["grade"].shape == (5,)
    _close({k: v for k, v in got.items() if k != "grade"},
           {k: v for k, v in want.items() if k != "grade"})
    margin = np.sort(want["pred_fuse"], axis=1)
    clear = margin[:, -1] - margin[:, -2] > 1e-3  # no near-tie argmax
    np.testing.assert_array_equal(got["grade"][clear], want["grade"][clear])
    saved = pickle.load(open(out_pkl, "rb"))
    assert saved["files"] == files


def test_port_checkpoint_serves_in_jax(tmp_path):
    """A checkpoint the port writes (flax layout via flax_from_state_dict)
    loads in the JAX package and gives the port's forward."""
    opt = Options(**DIMS)
    model = define_model(opt, generator=torch.Generator().manual_seed(5))
    params, stats = flax_from_state_dict(model.state_dict())
    path = os.path.join(str(tmp_path), "m_1.pt")
    save_checkpoint(path, {"split": 1, "opt": opt, "model_state_dict": params,
                           "batch_stats": stats, "metrics": {"acc": 0.5}})
    ckpt = j_load_checkpoint(path)
    assert ckpt["opt"]["path_dim"] == 16 and ckpt["metrics"] == {"acc": 0.5}
    jopt = JOptions(**DIMS)
    x_path, x_omic = _inputs(2, 6)
    want = j_make_infer_fn(jopt, j_define(jopt), ckpt["model_state_dict"],
                           ckpt["batch_stats"])(x_path, x_omic)
    got = make_infer_fn(opt, model)(x_path, x_omic)
    _close({k: v.numpy() for k, v in got.items()}, want)
    assert load_checkpoint(path)["split"] == 1


def test_checkpoint_holding_a_jax_array_fails_loudly(tmp_path):
    path = os.path.join(str(tmp_path), "m_1.pt")
    j_save_checkpoint(path, {"opt": JOptions(), "model_state_dict": {},
                             "metrics": jnp.ones(3)})
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        load_checkpoint(path)


PORT_MODULES = [
    "multimodal_learning_tpu_torch",
    "multimodal_learning_tpu_torch.config",
    "multimodal_learning_tpu_torch.config.options",
    "multimodal_learning_tpu_torch.models",
    "multimodal_learning_tpu_torch.models.common",
    "multimodal_learning_tpu_torch.models.resnet",
    "multimodal_learning_tpu_torch.models.maxnet",
    "multimodal_learning_tpu_torch.models.fusion",
    "multimodal_learning_tpu_torch.models.pathomic",
    "multimodal_learning_tpu_torch.models.factory",
    "multimodal_learning_tpu_torch.models.import_flax",
    "multimodal_learning_tpu_torch.ops",
    "multimodal_learning_tpu_torch.ops._build",
    "multimodal_learning_tpu_torch.ops.kron_fusion",
    "multimodal_learning_tpu_torch.utils",
    "multimodal_learning_tpu_torch.utils.checkpoint",
    "multimodal_learning_tpu_torch.serve",
    "multimodal_learning_tpu_torch.serve.export",
    "multimodal_learning_tpu_torch.cli",
    "multimodal_learning_tpu_torch.cli._platform",
    "multimodal_learning_tpu_torch.cli.export_model",
    "multimodal_learning_tpu_torch.cli.predict",
    "chip_smoke",
]


def test_port_imports_no_jax():
    """Every port module (and chip_smoke.py) imports without JAX or the JAX
    package, so the port runs on a machine that has neither."""
    pkg_dir = os.path.join(REPO, "multimodal_learning_tpu_torch")
    found = {os.path.relpath(os.path.join(d, f), REPO)[:-3]
             .replace(os.sep, ".").removesuffix(".__init__")
             for d, _, fs in os.walk(pkg_dir) for f in fs
             if f.endswith(".py")}
    assert found <= set(PORT_MODULES), found - set(PORT_MODULES)
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'multimodal_learning_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cli_without_cuda_refuses_to_fall_back(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs none")
    from multimodal_learning_tpu_torch.cli import export_model, predict
    monkeypatch.delenv("MML_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="MML_PLATFORM=cpu"):
        predict.main(["--artifact", os.path.join(str(tmp_path), "m.serve.pt"),
                      "--images_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="MML_PLATFORM=cpu"):
        export_model.main(["--checkpoints_dir", str(tmp_path)])
