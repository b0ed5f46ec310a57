"""The port's top-level exports, as the JAX package's
(``kandinsky5_tpu/__init__.py``): ``get_default_conf`` and a lazy
``get_T2V_pipeline``, whose module the package import leaves unloaded."""

import os
import subprocess
import sys

import kandinsky5_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_exports_the_factory_and_default_conf():
    from kandinsky5_tpu_torch import get_default_conf, get_T2V_pipeline
    from kandinsky5_tpu_torch.config import get_default_conf as conf_fn
    from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline as factory

    assert get_T2V_pipeline is factory and get_default_conf is conf_fn
    for name in ("Config", "load_config", "get_default_conf",
                 "get_T2V_pipeline"):
        assert name in kandinsky5_tpu_torch.__all__
    conf = get_default_conf("dit.safetensors", "vae/", "qwen/", "clip/")
    assert conf.model.checkpoint_path == "dit.safetensors"


def test_package_import_leaves_the_pipeline_unloaded():
    """In a fresh interpreter the package imports without the pipeline
    module (and so without the models and text towers); asking for the
    factory loads it."""
    code = ("import sys, kandinsky5_tpu_torch as k\n"
            "assert 'kandinsky5_tpu_torch.pipeline' not in sys.modules\n"
            "k.get_T2V_pipeline\n"
            "assert 'kandinsky5_tpu_torch.pipeline' in sys.modules\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_unknown_attribute_raises():
    import pytest

    with pytest.raises(AttributeError, match="no attribute"):
        kandinsky5_tpu_torch.get_t2v_pipeline  # noqa: B018
