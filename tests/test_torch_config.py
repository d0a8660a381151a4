"""The port's config-built entry against the JAX package's: the config
system and the config files, the nested-schema translation, the model
builder, ``train.loop.build_model`` and the synthetic dataset.

The port keeps its own copies of ``config.py``, ``registry.py``, the
configs and ``data/synthetic.py``; each is held here against the JAX
original on the same inputs.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.config import Config as JaxConfig
from fbbev_tpu.config import list_configs as jax_list_configs
from fbbev_tpu_torch.config import Config, list_configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "fbbev_tpu", "configs")
PORT_DIR = os.path.join(ROOT, "fbbev_tpu_torch", "configs")
NAMES = [os.path.relpath(p, JAX_DIR) for p in jax_list_configs(JAX_DIR)]
FLAGSHIP = "fbocc-r50-cbgs_depth_16f.py"
NESTED = "fbocc-r50-cbgs_depth_16f_nested.py"
BUILT = (FLAGSHIP, NESTED, "fbocc-r50_depth_1f.py",
         "fbocc-r50-tiny_synthetic.py", "fbocc-r50_synthetic_smoke.py",
         "fbocc-r50_synthetic_long.py")


def port_cfg(name):
    return Config.fromfile(os.path.join(PORT_DIR, name))


def jax_cfg(name):
    return JaxConfig.fromfile(os.path.join(JAX_DIR, name))


def test_the_port_has_every_config():
    assert len(NAMES) == 9 and os.path.join(
        "_base_", "default_runtime.py") in NAMES
    assert [os.path.relpath(p, PORT_DIR) for p in list_configs(PORT_DIR)] \
        == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax(name):
    """The port's copy read by the port's Config equals the JAX file read
    by the JAX Config, and the port's Config reads the JAX file alike."""
    want = jax_cfg(name).to_dict()
    assert port_cfg(name).to_dict() == want
    assert Config.fromfile(os.path.join(JAX_DIR, name)).to_dict() == want


def test_delete_and_merge_from_options_equal_jax():
    name = "fbocc-r50_synthetic_long.py"  # _delete_ two levels down
    got, want = port_cfg(name), jax_cfg(name)
    assert got.data.type == "SyntheticClipDataset"
    assert "data_root" not in got.data and "_delete_" not in got.data
    opts = {"model.history_cat_num": "4", "optimizer.base_lr": "1e-3",
            "data.batch_size": 3, "new.deep.key": "[1, (2, 3)]",
            "work_dir": "not a literal"}
    got.merge_from_options(opts)
    want.merge_from_options(opts)
    assert got.to_dict() == want.to_dict()
    assert got.model.history_cat_num == 4 and got.new.deep.key == [1, (2, 3)]


def test_nested_translation_equals_jax():
    from fbbev_tpu.models.builder import translate_reference_model_cfg as jt
    from fbbev_tpu_torch.models.builder import translate_reference_model_cfg
    model = port_cfg(NESTED).model.to_dict()
    assert translate_reference_model_cfg(model) == jt(
        jax_cfg(NESTED).model.to_dict())


def _jax_fields(name):
    from fbbev_tpu.models.builder import build_detector as jax_build
    jm = jax_build(jax_cfg(name).model.to_dict())
    return {f: getattr(jm, f) for f in jm.__dataclass_fields__
            if f not in ("parent", "name")}


def _same(port_value, jax_value):
    if isinstance(port_value, torch.dtype):
        return port_value == {"float32": torch.float32,
                              "bfloat16": torch.bfloat16}[
            jnp.dtype(jax_value).name]
    return port_value == jax_value


@pytest.mark.parametrize("name", BUILT)
def test_build_model_fields_equal_jax(name):
    """``train.loop.build_model`` builds every serving / synthetic config,
    and the model's constructor fields are the JAX model's: JAX's
    ``use_tiled_warp`` is the port's ``fuse_warp``, and the port's model
    has no ``readd`` (JAX's forward never reads it) and no
    ``backbone_arch`` (M12)."""
    from fbbev_tpu_torch.train.loop import _grid_size, build_model
    model = build_model(port_cfg(name), device="cpu")
    fields = _jax_fields(name)
    renamed = {"use_tiled_warp": "fuse_warp"}
    for f, v in fields.items():
        if f in ("grid_config", "bevformer_grid_config") and v is None:
            continue  # both packages take their default grid
        if f in ("readd", "backbone_arch"):
            assert not hasattr(model, f), f
            continue
        got = getattr(model, renamed.get(f, f))
        assert _same(got, v), (f, got, v)
    assert model.dtype == torch.bfloat16 or name.startswith(
        "fbocc-r50-tiny")
    assert _grid_size(model) == model.forward_projection.grid_size


def test_flat_and_nested_flagship_build_the_same_model():
    from fbbev_tpu_torch.models.builder import detector_kwargs
    flat = detector_kwargs(port_cfg(FLAGSHIP).model.to_dict())
    nested = detector_kwargs(port_cfg(NESTED).model.to_dict())
    for k in set(flat) & set(nested):
        assert flat[k] == nested[k], k
    assert flat["dtype"] == nested["dtype"] == torch.bfloat16


@pytest.mark.parametrize("name, milestone", [
    ("fbocc-vov99_depth_16f_512x1408.py", "M12"),
    ("fbbev-r50-det_16f.py", "M11")])
def test_unported_configs_raise(name, milestone):
    from fbbev_tpu_torch.train.loop import build_model
    with pytest.raises(NotImplementedError, match=milestone):
        build_model(port_cfg(name), device="cpu")


def test_registry_builds_the_port_fbocc():
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.models.builder import detector_kwargs
    from fbbev_tpu_torch.registry import DETECTORS, build_from_cfg
    assert DETECTORS.get("FBOCC") is FBOCC
    kw = detector_kwargs({"type": "FBOCC", "use_tiled_warp": False,
                          "readd": True, "backbone_arch": "V-99-eSE"})
    assert kw == {"fuse_warp": False}
    with pytest.raises(KeyError, match="VoVNetCP"):
        build_from_cfg({"type": "VoVNetCP"}, DETECTORS)
    assert build_from_cfg(None, DETECTORS) is None


def test_synthetic_dataset_equals_jax():
    from fbbev_tpu.data import SyntheticClipDataset as JaxDataset
    from fbbev_tpu.data import collate as jax_collate
    from fbbev_tpu_torch.data import SyntheticClipDataset, collate
    kw = dict(n_scenes=2, frames_per_scene=3, input_size=(32, 88),
              num_cams=2, occ_shape=(20, 20, 4), seed=5)
    got, want = SyntheticClipDataset(**kw), JaxDataset(**kw)
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got.flag, want.flag)
    for i in (0, 1, 4):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a = collate([got[0], got[4]])
    b = jax_collate([want[0], want[4]])
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_new_modules_import_without_jax():
    """The config-built entry imports, reads every config and builds the
    tiny model with ``jax`` unimportable, loading nothing of the JAX
    package."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from fbbev_tpu_torch.config import Config, list_configs\n"
        "from fbbev_tpu_torch.train.loop import build_model\n"
        "import fbbev_tpu_torch.tools.serving_bench, "
        "fbbev_tpu_torch.tools.benchmark, fbbev_tpu_torch.utils.fuse_bn, "
        "fbbev_tpu_torch.data\n"
        "cfgs = [Config.fromfile(p) for p in "
        "list_configs('fbbev_tpu_torch/configs')]\n"
        "assert len(cfgs) == 9\n"
        "build_model(Config.fromfile('fbbev_tpu_torch/configs/"
        "fbocc-r50-tiny_synthetic.py'), device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'fbbev_tpu' or "
        "m.startswith('fbbev_tpu.') or m.startswith('jax.') or "
        "(m == 'jax' and sys.modules[m] is not None)]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)
