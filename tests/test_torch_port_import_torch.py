"""The port's checkpoint import (``models/import_torch.py``,
``cli/convert_torch``) against the JAX package's.

From in-process torch state dicts drawn from a seed (a torchvision-style
ResNet18 file with a 1000-way ``fc`` and ``num_batches_tracked``, a
reference ResNet with its ``fc_new*`` heads, and a released wrapper
``{model_state_dict, ema_model_state_dict, ...}`` of a whole pofusion
model), the port's ``convert_torch`` writes an ``.npz`` with the same keys
and ``array_equal`` arrays as the JAX CLI's.  Then ``merge_pretrained``,
where a ResNet-only file lands, the refusal of a file that matches
nothing, and the teacher's and student's init paths consuming a file
(mirroring ``tests/test_pretrained.py``).  Exact comparisons throughout.
"""
import argparse
import os

import numpy as np
import pytest
import torch

from multimodal_learning_tpu.cli.convert_torch import main as j_convert
from multimodal_learning_tpu.models.import_torch import \
    merge_pretrained as j_merge
from multimodal_learning_tpu_torch.cli.convert_torch import main as convert
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.models.import_torch import (
    apply_pretrained, load_pretrained_npz, merge_pretrained,
    save_pretrained_npz)
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.steps import init_teacher_state
from multimodal_learning_tpu_torch.train.student import init_student_state

DIMS = dict(mode="pathomic", task="grad", path_dim=16, omic_dim=16,
            mmhid=16, feat_dim=8, input_size_path=32, batch_size=4,
            CRD_distill=0, pred_distill=0, reg_type="none",
            pallas_fusion="train")


def _opt(**kw):
    return Options(**dict(DIMS, **kw))


def _perturbed(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.num_batches_tracked.fill_(7)
    return model


def _resnet_sd(seed):
    model = define_model(_opt(mode="path"),
                         generator=torch.Generator().manual_seed(seed))
    return _perturbed(model, seed).state_dict()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The checkpoints both CLIs convert, written with ``torch.save``."""
    tmp = tmp_path_factory.mktemp("torch_ckpts")
    tv = {k: v for k, v in _resnet_sd(1).items()
          if not k.startswith("fc_new")}
    gen = torch.Generator().manual_seed(2)
    tv["fc.weight"] = torch.randn(1000, 512, generator=gen)
    tv["fc.bias"] = torch.randn(1000, generator=gen)
    models = [_perturbed(define_model(_opt(), generator=torch.Generator()
                                      .manual_seed(s)), s) for s in (3, 4)]
    released = {
        "split": 1, "opt": argparse.Namespace(mode="pathomic", task="grad"),
        "epoch": 30, "data": {"placeholder": 0},
        "model_state_dict": models[0].state_dict(),
        "ema_model_state_dict": models[1].state_dict(),
        "optimizer_state_dict": {"param_groups": [], "state": {}},
        "metrics": {"loss": [1.0]}}
    paths = {}
    for name, obj in (("torchvision", tv), ("heads", _resnet_sd(5)),
                      ("released", released)):
        paths[name] = str(tmp / f"{name}.pt")
        torch.save(obj, paths[name])
    return paths, tmp


CASES = {
    "torchvision": ("torchvision", []),
    "heads": ("heads", []),
    "released_model": ("released", ["--arch", "pathomic"]),
    "released_ema": ("released", ["--arch", "pathomic", "--state_key",
                                  "ema_model_state_dict"]),
    "released_trunk": ("released", ["--prefix", "path_net.", "--state_key",
                                    "ema_model_state_dict"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_torch_npz_equals_jax(case, sources):
    paths, tmp = sources
    src, flags = CASES[case]
    got, want = str(tmp / f"{case}_port.npz"), str(tmp / f"{case}_jax.npz")
    assert convert(["--src", paths[src], "--dst", got, *flags]) == 0
    assert j_convert(["--src", paths[src], "--dst", want, *flags]) == 0
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert not any("fc/" in k or "num_batches" in k for k in g.files)
    for path in (got, want):   # ResNet18-sized files: keep the tmp dir small
        os.remove(path)


def test_convert_torch_refuses_a_missing_state_key(sources):
    paths, tmp = sources
    with pytest.raises(KeyError, match="no 'bogus_key'"):
        convert(["--src", paths["released"], "--dst", str(tmp / "x.npz"),
                 "--state_key", "bogus_key"])


def test_merge_pretrained_matches_jax_and_leaves_a_shape_mismatch():
    tgt = {"a": {"kernel": np.zeros((3, 3), np.float32)},
           "b": np.ones(4, np.float32), "c": np.ones(2, np.float32)}
    src = {"a": {"kernel": np.full((2, 2), 7.0)}, "b": np.full(4, 7.0),
           "d": np.ones(3)}
    merged, n = merge_pretrained(tgt, src)
    want, n_want = j_merge(tgt, src)
    assert n == n_want == 1
    np.testing.assert_array_equal(merged["a"]["kernel"], np.zeros((3, 3)))
    np.testing.assert_array_equal(merged["b"], np.full(4, 7.0))
    assert merged["b"].dtype == np.float32          # cast to the target's
    for k in ("b", "c"):
        np.testing.assert_array_equal(merged[k], want[k])


def _trunk_npz(tmp_path, seed=1):
    """A ResNet-only file (no heads) from a port ResNet18 with perturbed
    BatchNorm statistics."""
    from multimodal_learning_tpu_torch.models import flax_from_state_dict
    params, stats = flax_from_state_dict(_resnet_sd(seed))
    path = str(tmp_path / "trunk.npz")
    save_pretrained_npz(path, {k: v for k, v in params.items()
                               if not k.startswith("fc_new")},
                        {k: v for k, v in stats.items()
                         if not k.startswith("fc_new")})
    return path


def test_resnet_only_file_lands_under_path_net_and_at_the_root(tmp_path):
    path = _trunk_npz(tmp_path)
    src = _resnet_sd(1)
    for opt, kw, prefix in ((_opt(), {}, "path_net."),
                            (_opt(), {"path_only": True}, "")):
        model = define_model(opt, generator=torch.Generator().manual_seed(0),
                             **kw)
        drawn = {k: v.clone() for k, v in model.state_dict().items()}
        sd = apply_pretrained(opt.replace(pretrained_path=path),
                              model).state_dict()
        for k, v in src.items():
            if k.startswith("fc_new"):
                assert torch.equal(sd[prefix + k], drawn[prefix + k]), k
            elif not k.endswith("num_batches_tracked"):
                assert torch.equal(sd[prefix + k], v), k
        # the omic branch, the fusion and the classifier stay as drawn
        others = [k for k in sd if not k.startswith(prefix)]
        assert all(torch.equal(sd[k], drawn[k]) for k in others)
        assert bool(others) == bool(prefix)


def test_a_file_matching_nothing_raises(tmp_path):
    bogus = str(tmp_path / "bogus.npz")
    save_pretrained_npz(bogus, {"nonexistent": {"kernel": np.zeros((2, 2))}},
                        {})
    opt = _opt(mode="path", pretrained_path=bogus)
    with pytest.raises(ValueError, match="no parameter matched"):
        init_teacher_state(opt, define_model(opt), make_lr_schedule(opt, 4),
                           16, device="cpu")


def test_teacher_and_student_init_consume_the_file(tmp_path):
    path = _trunk_npz(tmp_path)
    src_params, src_stats = load_pretrained_npz(path)
    conv1 = torch.from_numpy(src_params["conv1"]["kernel"].transpose(
        3, 2, 0, 1).copy())
    for student in (False, True):
        opt = _opt(pretrained_path=path, distill="kd")
        build = lambda o: define_model(
            o, path_only=student, generator=torch.Generator().manual_seed(0))
        init = init_student_state if student else init_teacher_state
        state = init(opt, build(opt), make_lr_schedule(opt, 4), 16,
                     device="cpu")
        rand = init(_opt(distill="kd"), build(_opt()),
                    make_lr_schedule(opt, 4), 16, device="cpu")
        trunk = state.model if student else state.model.path_net
        rand_trunk = rand.model if student else rand.model.path_net
        assert torch.equal(trunk.conv1.weight, conv1)
        assert torch.equal(trunk.layer4[1].conv2.weight, torch.from_numpy(
            src_params["layer4_1"]["conv2"]["kernel"].transpose(
                3, 2, 0, 1).copy()))
        assert torch.equal(trunk.bn1.running_mean,
                           torch.from_numpy(src_stats["bn1"]["mean"]))
        # the heads were absent from the file: they stay as drawn
        assert torch.equal(trunk.fc_new1[0].weight,
                           rand_trunk.fc_new1[0].weight)
        # the EMA starts from the pretrained weights
        ema = state.ema_model if student else state.ema_model.path_net
        for k, v in trunk.state_dict().items():
            assert torch.equal(ema.state_dict()[k], v), k
